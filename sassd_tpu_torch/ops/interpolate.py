"""Ring 3-NN feature interpolation of the aux branch (kernel K11).

The host rulebook's aux plan ``aux{L}`` [B, 27, N] gives, for every
level-0 voxel (query), the level-L rows of the 3x3x3 ring of cells around
its parent cell (cell0 >> L), -1 where a cell is inactive. The candidate
centres are arithmetic in the tap order, so only the 3 winners' features
are gathered. Weights are the inverse squared distances of the 3 nearest
found candidates, normalised; the gradient goes to the features only (the
queries are voxel centroids and carry none).

``neighborhood_interpolate_cells`` runs K11 (``csrc/interpolate.cu``)
forward and backward on CUDA tensors, and the plain PyTorch version under
ordinary autograd on CPU tensors.
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
                        cuda.P])
_K11_BWD = cuda.Kernel("sassd_ring_interp_bwd",
                       [cuda.P, cuda.P, cuda.P, cuda.I, cuda.I, cuda.P])
KERNEL_SYMBOLS = {"K11": ("sassd_ring_interp_fwd", "sassd_ring_interp_bwd")}


def ring_select_plain(query_xyz: torch.Tensor, query_cell0: torch.Tensor,
                      level: int, plan: torch.Tensor, rows_per_sample: int,
                      voxel_size_xyz: Sequence[float],
                      pc_min_xyz: Sequence[float]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 3 winners of every query: flat feature rows [B*N, 3] (b * M +
    row; 0 where missing) and normalised weights [B*N, 3] (0 where
    missing). The float32 operations of K11, in its order."""
    b, _, n = plan.shape
    dev = query_xyz.device
    parent = query_cell0.to(torch.int32) >> level                 # [B,N,3]
    off = torch.from_numpy(_OFFSETS27).to(dev, torch.int32)
    cand = parent[:, None] + off[None, :, None, :]              # [B,27,N,3]
    vs = torch.tensor(voxel_size_xyz, dtype=torch.float32, device=dev)
    pc = torch.tensor(pc_min_xyz, dtype=torch.float32, device=dev)
    centers = (cand.flip(-1).to(torch.float32) + 0.5) * vs + pc
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
    """K11's forward: (out [B, N, C], rows [B*N, 3], weights [B*N, 3])."""
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
    dev = feats.device
    with torch.cuda.device(dev):
        out = torch.empty((b, n, c), dtype=torch.float32, device=dev)
        rows = torch.empty((b * n, 3), dtype=torch.int32, device=dev)
        w = torch.empty((b * n, 3), dtype=torch.float32, device=dev)
        _K11_FWD.launch(query_xyz.data_ptr(), query_cell0.data_ptr(),
                        plan.data_ptr(), int(plan.dtype == torch.int16), b, n,
                        int(level), feats.data_ptr(), m, c,
                        *[float(v) for v in voxel_size_xyz],
                        *[float(v) for v in pc_min_xyz], out.data_ptr(),
                        rows.data_ptr(), w.data_ptr())
    return out, rows, w


def ring_interp_bwd(d_out: torch.Tensor, rows: torch.Tensor, w: torch.Tensor,
                    feats_shape) -> torch.Tensor:
    """K11's backward: d_feats [B, M, C] from d_out [B, N, C] and the
    forward's rows and weights."""
    cuda.check_cuda("d_out", d_out, torch.float32, 3)
    b, m, c = feats_shape
    dev = d_out.device
    with torch.cuda.device(dev):
        d_feats = torch.zeros((b, m, c), dtype=torch.float32, device=dev)
        _K11_BWD.launch(d_out.data_ptr(), rows.data_ptr(), w.data_ptr(),
                        rows.shape[0], c, d_feats.data_ptr())
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
                                   pc_min_xyz: Sequence[float]
                                   ) -> torch.Tensor:
    """Interpolate level-`level` features onto level-0 voxel centroids.

    query_xyz: [B, N, 3] float32 centroids; query_cell0: [B, N, 3] int32
    zyx level-0 cells (-1 padding); feats: [B, M, C] float32 level rows;
    plan: the host rulebook's [B, 27, N] aux plan (int16 or int32, rows
    into each sample's M rows, -1 missing); voxel_size_xyz / pc_min_xyz:
    the level's voxel size and the grid origin. Returns [B, N, C] (0 where
    no candidate exists), differentiable in `feats`.
    """
    if feats.device.type == "cpu":
        return neighborhood_interpolate_cells_plain(
            query_xyz, query_cell0, level, feats, plan, voxel_size_xyz,
            pc_min_xyz)
    return _RingInterpFn.apply(feats, query_xyz.contiguous(),
                               query_cell0.contiguous(), plan, int(level),
                               tuple(voxel_size_xyz), tuple(pc_min_xyz))
