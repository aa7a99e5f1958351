"""Rank placement of the data-parallel runs (the host-side parts of the
JAX package's ``parallel/mesh.py``).

The JAX package builds a ``jax.sharding.Mesh`` with a data axis (and an
optional spatial one), places each host's slice of the global batch on it
with ``NamedSharding`` and replicates the weights; XLA then inserts the
collectives. PyTorch has no mesh or sharding annotation, so those objects
are not ported: each rank holds a full replica on its own device, loads
its strided slice of every global batch, and the step reduces explicitly
(parallel/dist.py). What carries over is the host's shard of the data and
the rank's device.
"""
from __future__ import annotations

import os
from typing import Tuple

import torch

from . import dist


def host_shard_info() -> Tuple[int, int]:
    """(num_shards, shard_id) = (world size, rank) for the loader's
    strided slice of each global batch; (1, 0) without a process group."""
    return dist.process_count(), dist.process_index()


def local_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK}`` (LOCAL_RANK default 0)
    for a CUDA device without an index, `device` itself otherwise (the
    CPU when the caller asks for it)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return d
