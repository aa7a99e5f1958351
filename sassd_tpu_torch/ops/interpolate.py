"""3-NN feature interpolation of the aux branch: ring (kernel K11) and
exact (kernel K15).

Ring: the rulebook's aux plan ``aux{L}`` [B, 27, N] gives, for every
level-0 voxel (query), the level-L rows of the 3x3x3 ring of cells around
its parent cell (cell0 >> L), -1 where a cell is inactive. The candidate
centres are arithmetic in the tap order, so only the 3 winners' features
are gathered. Weights are the inverse squared distances of the 3 nearest
found candidates, normalised. The grid origin is one [3] point, or one per
sample row ([B, 3], the banded stage's per-band origins).

Exact: every active cell centre of the level is a candidate, by the
expanded squared distance |u|^2 + |k|^2 - 2 u.k of the JAX package
(``three_nn_interpolate``); padded cells get 1e10 added.

``neighborhood_interpolate`` is the ring 3-NN over given candidate
centres (the JAX package's form, plain PyTorch; no path calls it).

In both the gradient goes to the features only (the queries are voxel
centroids and the centres cell arithmetic, neither a parameter).
``neighborhood_interpolate_cells`` runs K11 (``csrc/interpolate.cu``)
forward and backward on CUDA tensors, ``three_nn_interpolate`` K15 forward
and K11's backward; on CPU tensors each runs its plain PyTorch version
under ordinary autograd.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from . import cuda

_BIG = 1e10
# tap k = (dz, dy, dx) row-major over {-1, 0, 1}, as the aux plans
_OFFSETS27 = np.stack(np.meshgrid(*[np.arange(3) - 1] * 3, indexing="ij"),
                      -1).reshape(27, 3)

_K11_FWD = cuda.Kernel("sassd_ring_interp_fwd",
                       [cuda.P, cuda.P, cuda.P, cuda.I, cuda.I, cuda.I,
                        cuda.I, cuda.P, cuda.I, cuda.I, cuda.F, cuda.F,
                        cuda.F, cuda.F, cuda.F, cuda.F, cuda.P, cuda.P,
                        cuda.P, cuda.P])
_K11_BWD = cuda.Kernel("sassd_ring_interp_bwd",
                       [cuda.P, cuda.P, cuda.P, cuda.I, cuda.I, cuda.P,
                        cuda.I])
_K15 = cuda.Kernel("sassd_three_nn_fwd",
                   [cuda.P, cuda.I, cuda.I, cuda.P, cuda.P, cuda.I, cuda.I,
                    cuda.P, cuda.I, cuda.P, cuda.P, cuda.P, cuda.P, cuda.P])
KERNEL_SYMBOLS = {"K11": ("sassd_ring_interp_fwd", "sassd_ring_interp_bwd"),
                  "K15": ("sassd_three_nn_fwd",)}
# K15's search grid takes the known rows in slices of at least this many
K15_MIN_SLICE = 256
# queries per step of the plain exact 3-NN: bounds its [B, chunk, M]
# distance matrix (1.5 GB a level and sample unchunked at the car caps)
THREE_NN_CHUNK = 512


def cell_centers(coords_zyx: torch.Tensor, voxel_size_xyz: Sequence[float],
                 pc_min_xyz) -> torch.Tensor:
    """[..., 3] integer zyx cells -> [..., 3] float32 xyz centres,
    (cell + 0.5) * voxel size + grid origin (the candidate points of both
    3-NN forms; padding cells give finite centres off the grid). The
    origin is a [3] sequence or a float32 tensor that broadcasts."""
    dev = coords_zyx.device
    vs = torch.tensor(voxel_size_xyz, dtype=torch.float32, device=dev)
    pc = torch.as_tensor(pc_min_xyz, dtype=torch.float32, device=dev)
    return (coords_zyx.flip(-1).to(torch.float32) + 0.5) * vs + pc


def ring_select_plain(query_xyz: torch.Tensor, query_cell0: torch.Tensor,
                      level: int, plan: torch.Tensor, rows_per_sample: int,
                      voxel_size_xyz: Sequence[float], pc_min_xyz
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 3 winners of every query: flat feature rows [B*N, 3] (b * M +
    row; 0 where missing) and normalised weights [B*N, 3] (0 where
    missing). pc_min_xyz: the grid origin, a [3] sequence or a [B, 3]
    float32 tensor of one origin per row. The float32 operations of K11,
    in its order."""
    b, _, n = plan.shape
    dev = query_xyz.device
    parent = query_cell0.to(torch.int32) >> level                 # [B,N,3]
    off = torch.from_numpy(_OFFSETS27).to(dev, torch.int32)
    cand = parent[:, None] + off[None, :, None, :]              # [B,27,N,3]
    if torch.is_tensor(pc_min_xyz):
        pc_min_xyz = pc_min_xyz[:, None, None, :]
    centers = cell_centers(cand, voxel_size_xyz, pc_min_xyz)
    d = centers - query_xyz[:, None]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    found = plan >= 0
    d2 = torch.where(found, d2, _BIG)
    # the 3 smallest, ties to the lower tap (a stable sort)
    sel = torch.sort(d2, dim=1, stable=True).indices[:, :3]     # [B,3,N]
    d2_3 = torch.gather(d2, 1, sel)
    ok = torch.gather(found, 1, sel)
    idx = torch.gather(torch.clamp(plan.to(torch.int64), min=0), 1, sel)
    w = torch.where(ok, 1.0 / (d2_3 + 1e-8), 0.0)
    denom = w[:, 0] + w[:, 1] + w[:, 2]
    w = w / torch.where(denom > 0, denom, 1.0)[:, None]
    base = torch.arange(b, device=dev)[:, None, None] * rows_per_sample
    rows = (idx + base).transpose(1, 2).reshape(b * n, 3)
    return rows, w.transpose(1, 2).reshape(b * n, 3)


def gather_sum_plain(feats: torch.Tensor, rows: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """sum_i w[:, i] * feats[rows[:, i]] over flat [B*M, C] features, in
    K11's order."""
    f = feats[rows]                                             # [Q, 3, C]
    return (f[:, 0] * w[:, 0:1] + f[:, 1] * w[:, 1:2]) + f[:, 2] * w[:, 2:3]


def neighborhood_interpolate_cells_plain(query_xyz, query_cell0, level,
                                         feats, plan, voxel_size_xyz,
                                         pc_min_xyz) -> torch.Tensor:
    """Plain PyTorch version of K11 (see neighborhood_interpolate_cells)."""
    b, m, c = feats.shape
    rows, w = ring_select_plain(query_xyz, query_cell0, level, plan, m,
                                voxel_size_xyz, pc_min_xyz)
    return gather_sum_plain(feats.reshape(b * m, c), rows,
                            w).reshape(b, -1, c)


def ring_interp_fwd(query_xyz, query_cell0, level, feats, plan,
                    voxel_size_xyz, pc_min_xyz):
    """K11's forward: (out [B, N, C], rows [B*N, 3], weights [B*N, 3]).
    pc_min_xyz: a [3] sequence, or a [B, 3] float32 CUDA tensor of one
    grid origin per row."""
    cuda.check_cuda("query_xyz", query_xyz, torch.float32, 3)
    cuda.check_cuda("query_cell0", query_cell0, torch.int32, 3)
    cuda.check_cuda("feats", feats, torch.float32, 3)
    if plan.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"plan must be int16 or int32, got {plan.dtype}")
    cuda.check_cuda("plan", plan, plan.dtype, 3)
    b, m, c = feats.shape
    n = plan.shape[2]
    if (plan.shape != (b, 27, n) or query_xyz.shape != (b, n, 3)
            or query_cell0.shape != (b, n, 3)):
        raise ValueError(f"plan {tuple(plan.shape)}, queries "
                         f"{tuple(query_xyz.shape)}, cells "
                         f"{tuple(query_cell0.shape)} do not fit feats "
                         f"{tuple(feats.shape)}")
    origins = None
    if torch.is_tensor(pc_min_xyz):
        cuda.check_cuda("pc_min_xyz", pc_min_xyz, torch.float32, 2)
        if pc_min_xyz.shape != (b, 3):
            raise ValueError(f"origins {tuple(pc_min_xyz.shape)} are not "
                             f"[{b}, 3]")
        origins, pc_min_xyz = pc_min_xyz.data_ptr(), (0.0, 0.0, 0.0)
    dev = feats.device
    with torch.cuda.device(dev):
        out = torch.empty((b, n, c), dtype=torch.float32, device=dev)
        rows = torch.empty((b * n, 3), dtype=torch.int32, device=dev)
        w = torch.empty((b * n, 3), dtype=torch.float32, device=dev)
        _K11_FWD.launch(query_xyz.data_ptr(), query_cell0.data_ptr(),
                        plan.data_ptr(), int(plan.dtype == torch.int16), b, n,
                        int(level), feats.data_ptr(), m, c,
                        *[float(v) for v in voxel_size_xyz],
                        *[float(v) for v in pc_min_xyz], origins,
                        out.data_ptr(), rows.data_ptr(), w.data_ptr())
    return out, rows, w


def ring_interp_bwd(d_out: torch.Tensor, rows: torch.Tensor, w: torch.Tensor,
                    feats_shape) -> torch.Tensor:
    """K11's backward: d_feats [B, M, C] from d_out [B, N, C] and the
    forward's rows and weights (the entry point zeroes d_feats)."""
    cuda.check_cuda("d_out", d_out, torch.float32, 3)
    b, m, c = feats_shape
    dev = d_out.device
    with torch.cuda.device(dev):
        d_feats = torch.empty((b, m, c), dtype=torch.float32, device=dev)
        _K11_BWD.launch(d_out.data_ptr(), rows.data_ptr(), w.data_ptr(),
                        rows.shape[0], c, d_feats.data_ptr(), b * m)
    return d_feats


class _RingInterpFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, feats, query_xyz, query_cell0, plan, level, vs, pc):
        out, rows, w = ring_interp_fwd(query_xyz, query_cell0, level, feats,
                                       plan, vs, pc)
        ctx.save_for_backward(rows, w)
        ctx.feats_shape = tuple(feats.shape)
        return out

    @staticmethod
    def backward(ctx, d_out):
        rows, w = ctx.saved_tensors
        d_feats = ring_interp_bwd(d_out.contiguous(), rows, w,
                                  ctx.feats_shape)
        return d_feats, None, None, None, None, None, None


def neighborhood_interpolate_cells(query_xyz: torch.Tensor,
                                   query_cell0: torch.Tensor, level: int,
                                   feats: torch.Tensor, plan: torch.Tensor,
                                   voxel_size_xyz: Sequence[float],
                                   pc_min_xyz) -> torch.Tensor:
    """Interpolate level-`level` features onto level-0 voxel centroids.

    query_xyz: [B, N, 3] float32 centroids; query_cell0: [B, N, 3] int32
    zyx level-0 cells (-1 padding); feats: [B, M, C] float32 level rows;
    plan: the host rulebook's [B, 27, N] aux plan (int16 or int32, rows
    into each sample's M rows, -1 missing); voxel_size_xyz / pc_min_xyz:
    the level's voxel size and the grid origin, a [3] sequence or a [B, 3]
    float32 tensor of one origin per row. Returns [B, N, C] (0 where no
    candidate exists), differentiable in `feats`.
    """
    if feats.device.type == "cpu":
        return neighborhood_interpolate_cells_plain(
            query_xyz, query_cell0, level, feats, plan, voxel_size_xyz,
            pc_min_xyz)
    pc = (pc_min_xyz.contiguous() if torch.is_tensor(pc_min_xyz)
          else tuple(pc_min_xyz))
    return _RingInterpFn.apply(feats, query_xyz.contiguous(),
                               query_cell0.contiguous(), plan, int(level),
                               tuple(voxel_size_xyz), pc)


def neighborhood_interpolate(query_xyz: torch.Tensor,
                             centers: torch.Tensor, feats: torch.Tensor,
                             plan_idx: torch.Tensor) -> torch.Tensor:
    """3-NN interpolation over a given candidate neighbourhood, the
    candidates' centres given (K11 computes them from the cells instead).

    query_xyz [N, 3]; centers [M, 3]; feats [M, C]; plan_idx [27, N] int
    rows into centers / feats, -1 missing. Weights are 1 / (d^2 + 1e-8)
    over the 3 nearest found candidates, normalised; a row with fewer
    than 3 uses those it has, and one with none gives 0. Ties go to the
    lower candidate (a stable sort). No path of the detector calls it.
    """
    found = plan_idx >= 0                                       # [27, N]
    idx = torch.clamp(plan_idx.to(torch.int64), min=0)
    d2 = torch.sum((centers[idx] - query_xyz[None]) ** 2, dim=-1)
    d2 = torch.where(found, d2, _BIG)
    sel = torch.sort(d2, dim=0, stable=True).indices[:3]        # [3, N]
    d2_3 = torch.gather(d2, 0, sel)
    ok = torch.gather(found, 0, sel)
    rows = torch.gather(idx, 0, sel)
    w = torch.where(ok, 1.0 / (d2_3 + 1e-8), 0.0)
    denom = torch.sum(w, dim=0)
    w = w / torch.where(denom > 0, denom, 1.0)
    return torch.sum(feats[rows] * w[..., None], dim=0)


def three_nn_select_plain(query_xyz: torch.Tensor, known_xyz: torch.Tensor,
                          known_valid: torch.Tensor,
                          chunk: int = THREE_NN_CHUNK
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact 3 nearest known points of every query: flat feature rows
    [B*N, 3] (b * M + row) and normalised weights [B*N, 3]. The float32
    operations of K15, in its order; the 3 smallest d2 by repeated argmin
    (the first minimum: lax.top_k's lower index on ties)."""
    b, n, _ = query_xyz.shape
    m = known_xyz.shape[1]
    dev = query_xyz.device
    kx, ky, kz = (known_xyz[..., i][:, None] for i in range(3))  # [B,1,M]
    k2 = kx * kx + ky * ky + kz * kz
    bias = torch.where(known_valid, 0.0, _BIG).to(torch.float32)[:, None]
    rows, ws = [], []
    for s in range(0, n, chunk):
        u = query_xyz[:, s:s + chunk]
        ux, uy, uz = (u[..., i:i + 1] for i in range(3))         # [B,c,1]
        u2 = ux * ux + uy * uy + uz * uz
        dot = ux * kx + uy * ky + uz * kz                          # [B,c,M]
        d2 = torch.clamp((u2 + k2) - 2.0 * dot, min=0.0) + bias
        sel, best = [], []
        for _ in range(3):
            i = torch.argmin(d2, dim=-1, keepdim=True)
            sel.append(i)
            best.append(torch.gather(d2, -1, i))
            d2 = d2.scatter(-1, i, torch.inf)
        w = [1.0 / (v + 1e-8) for v in best]
        denom = w[0] + w[1] + w[2]
        ws.append(torch.cat([v / denom for v in w], -1))
        rows.append(torch.cat(sel, -1))
    base = torch.arange(b, device=dev)[:, None, None] * m
    return ((torch.cat(rows, 1) + base).reshape(b * n, 3),
            torch.cat(ws, 1).reshape(b * n, 3))


def three_nn_interpolate_plain(query_xyz, known_xyz, known_valid,
                               known_feats) -> torch.Tensor:
    """Plain PyTorch version of K15 (see three_nn_interpolate)."""
    b, m, c = known_feats.shape
    rows, w = three_nn_select_plain(query_xyz, known_xyz, known_valid)
    return gather_sum_plain(known_feats.reshape(b * m, c), rows,
                            w).reshape(b, -1, c)


def three_nn_slices(b: int, n: int, m: int, device) -> int:
    """The number of slices K15 splits each sample's m known rows into:
    enough for 4 blocks of the search grid on each SM of the device, but
    at most one slice per K15_MIN_SLICE rows, and at least 1. The library
    gives the queries a block of its grid takes."""
    per_block = cuda.load().sassd_three_nn_queries_per_block()
    tiles = max(1, b * -(-n // per_block))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-4 * sms // tiles), -(-m // K15_MIN_SLICE)))


def three_nn_fwd(query_xyz, known_xyz, known_valid, known_feats):
    """K15: (out [B, N, C], rows [B*N, 3], weights [B*N, 3])."""
    cuda.check_cuda("query_xyz", query_xyz, torch.float32, 3)
    cuda.check_cuda("known_xyz", known_xyz, torch.float32, 3)
    cuda.check_cuda("known_valid", known_valid, torch.bool, 2)
    cuda.check_cuda("known_feats", known_feats, torch.float32, 3)
    b, m, c = known_feats.shape
    n = query_xyz.shape[1]
    if (query_xyz.shape != (b, n, 3) or known_xyz.shape != (b, m, 3)
            or known_valid.shape != (b, m)):
        raise ValueError(f"queries {tuple(query_xyz.shape)}, known "
                         f"{tuple(known_xyz.shape)}, validity "
                         f"{tuple(known_valid.shape)} do not fit feats "
                         f"{tuple(known_feats.shape)}")
    dev = known_feats.device
    slices = three_nn_slices(b, n, m, dev)
    with torch.cuda.device(dev):
        out = torch.empty((b, n, c), dtype=torch.float32, device=dev)
        rows = torch.empty((b * n, 3), dtype=torch.int32, device=dev)
        w = torch.empty((b * n, 3), dtype=torch.float32, device=dev)
        # (d2, index) word pairs: each slice's top 3 of each query, and
        # each query's seed, the top 3 of a sample of the known rows
        part = torch.empty((b, slices, n, 3, 2), dtype=torch.float32,
                           device=dev)
        seed = torch.empty((b, n, 3, 2), dtype=torch.float32, device=dev)
        _K15.launch(query_xyz.data_ptr(), b, n, known_xyz.data_ptr(),
                    known_valid.data_ptr(), m, slices,
                    known_feats.data_ptr(), c, part.data_ptr(),
                    seed.data_ptr(), out.data_ptr(), rows.data_ptr(),
                    w.data_ptr())
    return out, rows, w


class _ThreeNNFn(torch.autograd.Function):
    """Exact 3-NN on the card: forward K15, backward K11's scatter."""

    @staticmethod
    def forward(ctx, feats, query_xyz, known_xyz, known_valid):
        out, rows, w = three_nn_fwd(query_xyz, known_xyz, known_valid, feats)
        ctx.save_for_backward(rows, w)
        ctx.feats_shape = tuple(feats.shape)
        return out

    @staticmethod
    def backward(ctx, d_out):
        rows, w = ctx.saved_tensors
        d_feats = ring_interp_bwd(d_out.contiguous(), rows, w,
                                  ctx.feats_shape)
        return d_feats, None, None, None


def three_nn_interpolate(query_xyz: torch.Tensor, known_xyz: torch.Tensor,
                         known_valid: torch.Tensor,
                         known_feats: torch.Tensor) -> torch.Tensor:
    """Interpolate a level's features onto the queries from their 3
    nearest known points (the exact aux 3-NN).

    query_xyz: [B, N, 3] float32; known_xyz: [B, M, 3] float32 cell
    centres; known_valid: [B, M] bool (padded rows are excluded, as far as
    a 1e10 distance excludes them); known_feats: [B, M, C] float32.
    Returns [B, N, C], differentiable in `known_feats`.
    """
    if known_feats.device.type == "cpu":
        return three_nn_interpolate_plain(query_xyz, known_xyz, known_valid,
                                          known_feats)
    return _ThreeNNFn.apply(known_feats, query_xyz.contiguous(),
                            known_xyz.contiguous(), known_valid.contiguous())
