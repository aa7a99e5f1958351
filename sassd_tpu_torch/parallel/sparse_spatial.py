"""The banded sparse stage: the level-0 active set split into S y-bands
with a halo on each side, every band run through the unchanged sparse
engine on a band-local grid, and the bands' owned rows of the last level
put back together into the BEV canvas (the JAX package's
``parallel/sparse_spatial.py``, on one device: the S * B band rows are one
batch of the device rulebook and VxNet; ``Detector.forward_spine`` runs
it).

- A band is the grid [D, band_h + 2 * halo, W] with y rebased to the
  band's lower edge lo = s * band_h - halo; cutting on y keeps keys sorted.
- Halo cells are recomputed in every band that holds them. The default
  halo of 64 level-0 rows covers the ladder's reach (25 rows through
  L0-L2, 8 * (3 + 1) through the dense tail and the aux ring) and is a
  multiple of 8, so band edges keep the stride-2 parity.
- BatchNorm statistics count only band-owned rows (VxNet's
  ``bn_owned_y``), so each active cell is counted once, as in the
  replicated run; the aux branch's loss runs on owned queries.
- A band whose grid reaches past the global grid's top edge clips its
  downsamples there (:func:`y_top_rows`), and its aux ring centres use the
  band's own grid origin (:func:`band_origins`).

Across the ranks of a process group (``parallel/mesh.Layout`` with S
spatial ranks), rank s of a data row runs band s alone: ``partition``
splits every band (one K16 launch) and the rank keeps its own, and
:func:`y_top_rows` / :func:`band_origins` give that band's rows. Its owned
level-3 rows are its slice of the canvas, which goes through the split
BEV trunk (parallel/spatial.py), as the JAX package assembles the canvas
H-sharded on the same axis.

Kernel K16 ``partition`` (``csrc/band_partition.cu``) splits the rows,
beside its plain PyTorch version, which the wrapper takes only for CPU
tensors.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from sassd_tpu_torch.config import SASSDConfig
from sassd_tpu_torch.ops import cuda

HALO = 64   # level-0 y cells; see the module docstring for the reach

_K16 = cuda.Kernel("sassd_band_partition",
                   [cuda.P, cuda.P, cuda.I, cuda.I, cuda.I, cuda.I, cuda.I,
                    cuda.I, cuda.I, cuda.P, cuda.P, cuda.P, cuda.P])
KERNEL_SYMBOLS = {"K16": ("sassd_band_partition",)}


class BandSpec(NamedTuple):
    s: int                    # bands
    band_h: int               # owned level-0 y cells per band (mult of 8)
    halo: int                 # halo cells each side (mult of 8)
    caps: Tuple[int, ...]     # per-band per-level row caps


def _mult8(x: int) -> int:
    return ((x + 7) // 8) * 8


def make_band_spec(cfg: SASSDConfig, s: int, cap_margin: float = 1.5,
                   halo: int = HALO) -> BandSpec:
    """Size the bands for `s` shards: caps scale with the band's covered
    fraction of the grid (owned + halo) times a safety margin."""
    h = cfg.sparse_shape[1]
    if h % (8 * s):
        raise ValueError(f"grid H={h} not divisible by 8*s={8 * s}")
    if halo % 8:
        raise ValueError("halo must be a multiple of 8 (stride parity)")
    band_h = h // s
    cover = min(band_h + 2 * halo, h) / h
    caps = tuple(min(c, _mult8(int(c * cover * cap_margin)) + 8)
                 for c in cfg.caps.level_caps)
    return BandSpec(s, band_h, halo, caps)


def config_band_spec(cfg: SASSDConfig) -> BandSpec:
    """The band spec of a banded config (parallel.spatial bands, its halo
    and cap margin)."""
    p = cfg.parallel
    return make_band_spec(cfg, p.spatial, p.band_cap_margin, p.band_halo)


def band_shape(cfg: SASSDConfig, spec: BandSpec) -> Tuple[int, int, int]:
    d, _h, w = cfg.sparse_shape
    return (d, spec.band_h + 2 * spec.halo, w)


def _bands(spec: BandSpec, band: Optional[int]) -> np.ndarray:
    return np.arange(spec.s) if band is None else np.array([band])


def y_top_rows(cfg: SASSDConfig, spec: BandSpec, b: int, device,
               band: Optional[int] = None) -> torch.Tensor:
    """[S*B] int32 exclusive band-local level-0 y bound of the global grid
    top (band-major rows, as :func:`partition` flattens them); [B], band
    `band`'s rows alone, when it is given."""
    h = cfg.sparse_shape[1]
    lo = _bands(spec, band) * spec.band_h - spec.halo
    return torch.from_numpy(np.repeat((h - lo).astype(np.int32), b)).to(
        device)


def band_origins(cfg: SASSDConfig, spec: BandSpec, b: int, device,
                 band: Optional[int] = None) -> torch.Tensor:
    """[S*B, 3] float32 xyz grid origin of each band row ([B, 3], band
    `band`'s alone, when it is given): the config's origin shifted by
    lo * voxel_size_y. The shift is float32, the sum is taken in float64
    and rounded to float32, as the JAX package does."""
    pcr0 = np.asarray(cfg.voxel.point_cloud_range[:3], np.float32)
    vs0 = np.asarray(cfg.voxel.voxel_size, np.float32)
    bands = _bands(spec, band)
    band_lo = (bands * spec.band_h - spec.halo).astype(np.float32)
    n = len(bands)
    rows = (np.repeat(pcr0[None], n, 0)
            + np.stack([np.zeros(n), band_lo * vs0[1], np.zeros(n)], 1))
    return torch.from_numpy(np.repeat(rows.astype(np.float32), b, 0)).to(
        device)


def partition_plain(coords: torch.Tensor, rows: torch.Tensor,
                    spec: BandSpec):
    """Plain PyTorch version of K16 (see partition)."""
    b, m, _ = coords.shape
    f = rows.shape[-1]
    cap = spec.caps[0]
    valid = coords[..., 0] >= 0
    y = coords[..., 1]
    out_c, out_r, over = [], [], []
    for s in range(spec.s):
        lo = s * spec.band_h - spec.halo
        hi = lo + spec.band_h + 2 * spec.halo
        mem = valid & (y >= lo) & (y < hi)
        rank = torch.cumsum(mem.to(torch.int64), 1) - 1
        dst = torch.where(mem & (rank < cap), rank, cap)[..., None]
        local = coords.clone()
        local[..., 1] -= lo
        bc = coords.new_full((b, cap + 1, 3), -1).scatter_(
            1, dst.expand(-1, -1, 3), local)
        br = rows.new_zeros((b, cap + 1, f)).scatter_(
            1, dst.expand(-1, -1, f), rows)
        out_c.append(bc[:, :cap])
        out_r.append(br[:, :cap])
        over.append(torch.clamp(mem.sum(1) - cap, min=0))
    return (torch.stack(out_c), torch.stack(out_r),
            torch.stack(over).to(torch.int32))


def partition(coords: torch.Tensor, rows: torch.Tensor, spec: BandSpec):
    """Split level-0 rows into the bands (K16 on the card).

    coords: [B, M, 3] int32 global zyx (-1 padding); rows: [B, M, F]
    float32. Band s carries the valid rows with y in [lo, hi) = [s * band_h
    - halo, (s + 1) * band_h + halo), in input order (key-sorted input
    stays sorted), at most spec.caps[0] of them. Returns band-local coords
    [S, B, cap0, 3] int32 (y - lo; -1 padding), rows [S, B, cap0, F] (0
    padding) and overflow [S, B] int32: the members beyond cap0, which are
    dropped (nonzero breaks the banded == replicated guarantee).
    """
    if coords.device.type == "cpu":
        return partition_plain(coords, rows, spec)
    cuda.check_cuda("coords", coords, torch.int32, 3)
    cuda.check_cuda("rows", rows, torch.float32, 3)
    b, m, _ = coords.shape
    f = rows.shape[2]
    if coords.shape[2] != 3 or rows.shape[:2] != (b, m):
        raise ValueError(f"coords {tuple(coords.shape)} / rows "
                         f"{tuple(rows.shape)} are not [B, M, 3] / [B, M, F]")
    cap = spec.caps[0]
    dev = coords.device
    # the kernels' tiles of rows, each counted into a scratch [B, tiles, S]
    tiles = max(1, -(-m // cuda.load().sassd_band_partition_tile_rows()))
    with torch.cuda.device(dev):
        counts = torch.empty((b, tiles, spec.s), dtype=torch.int32,
                             device=dev)
        out_c = torch.empty((spec.s, b, cap, 3), dtype=torch.int32,
                            device=dev)
        out_r = torch.empty((spec.s, b, cap, f), dtype=torch.float32,
                            device=dev)
        over = torch.empty((spec.s, b), dtype=torch.int32, device=dev)
        _K16.launch(coords.data_ptr(), rows.data_ptr(), b, m, f, spec.s,
                    spec.band_h, spec.halo, cap, counts.data_ptr(),
                    out_c.data_ptr(), out_r.data_ptr(), over.data_ptr())
    return out_c, out_r, over
