"""Rank placement of the multi-process runs (the host-side parts of the
JAX package's ``parallel/mesh.py``).

The JAX package builds a ``jax.sharding.Mesh`` of W / spatial data rows x
`spatial` spatial devices (``make_mesh``), places each host's slice of the
global batch on the data axis with ``NamedSharding`` and lets XLA insert
the collectives. PyTorch has no mesh or sharding annotation, so those
objects are not ported: each rank holds a full replica on its own device
and the collectives are explicit (parallel/dist.py). What carries over is
the layout itself (:class:`Layout`): with ``parallel.strategy`` "spatial"
or "banded" across W > 1 ranks, rank r sits at data index r // S and
spatial index r % S (S = ``parallel.spatial``), as ``make_mesh`` reshapes
its devices; the ranks of one data row load the same shard of every
global batch and split its BEV canvas (parallel/spatial.py) or its bands
(parallel/sparse_spatial.py). Otherwise S = 1 and every rank is a data row
of its own.
"""
from __future__ import annotations

import os
from typing import Any, NamedTuple, Tuple

import torch

from . import dist


class Layout(NamedTuple):
    """This rank's place in the data x spatial layout of the world."""
    data: int                  # data rows (the data axis's size)
    spatial: int               # spatial ranks per data row (S)
    data_index: int            # r // S
    spatial_index: int         # r % S
    # reductions over the data axis, the ranks of this spatial index
    # (None: every rank, which is the data axis when S = 1)
    data_group: Any = None
    # the ranks of this data row (None when S = 1)
    spatial_group: Any = None


def spatial_ranks(cfg) -> int:
    """S, the spatial ranks of a data row: ``parallel.spatial`` for the
    "spatial" and "banded" strategies under a process group of more than
    one rank, else 1 (one device runs the bands as batch rows and the
    canvas whole). Raises ValueError when S does not divide the world, as
    the JAX package's make_mesh does."""
    p, w = cfg.parallel, dist.process_count()
    if w == 1 or p.strategy not in ("spatial", "banded") or p.spatial <= 1:
        return 1
    if w % p.spatial:
        raise ValueError(f"{w} ranks not divisible by "
                         f"parallel.spatial={p.spatial}")
    return p.spatial


def layout(cfg=None) -> Layout:
    """This rank's Layout for `cfg` (without one, S = 1: every rank a
    data row). The subgroups are made on the first call for a given S,
    which every rank makes at the same point of the program."""
    w, r = dist.process_count(), dist.process_index()
    s = 1 if cfg is None else spatial_ranks(cfg)
    if s == 1:
        return Layout(w, 1, r, 0)
    rows, cols = dist.spatial_subgroups(s)
    d, i = divmod(r, s)
    return Layout(w // s, s, d, i, cols[i], rows[d])


def host_shard_info(cfg=None) -> Tuple[int, int]:
    """(num_shards, shard_id) = (data rows, data index) for the loader's
    strided slice of each global batch: (world size, rank) when S = 1,
    (1, 0) without a process group."""
    lay = layout(cfg)
    return lay.data, lay.data_index


def local_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK}`` (LOCAL_RANK default 0)
    for a CUDA device without an index, `device` itself otherwise (the
    CPU when the caller asks for it)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return d
