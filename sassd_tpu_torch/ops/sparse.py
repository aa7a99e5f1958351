"""Sparse 3D convolution over host-built gather plans.

Active voxels of a level live in fixed-capacity, key-sorted row arrays:
``keys [M]`` (linear zyx, INVALID_KEY padded) and ``feats [M, C]``. A
plan ``[27, M]`` holds, for each output row and kernel tap (dz, dy, dx
row-major over {-1, 0, 1}), the input row of the neighbour, with a
``found`` flag. A convolution gathers the 27 neighbour rows into an
im2col matrix [M, 27*Cin] (missing neighbours are zero) and multiplies it
by the [27*Cin, Cout] weight.

Batches run flat: the per-sample segments are concatenated along rows and
each sample's plan indices are offset by b * rows_in, so every conv is one
gather and one GEMM over the whole batch. Plans are built per sample, so
rows of another sample are never marked found.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

INVALID_KEY = torch.iinfo(torch.int32).max


class SubmPlan(NamedTuple):
    idx: torch.Tensor    # [K, M] int64 rows into the input level
    found: torch.Tensor  # [K, M] bool neighbour-exists flags


def coords_to_keys(coords_zyx: torch.Tensor,
                   shape_zyx: Tuple[int, int, int]) -> torch.Tensor:
    """[..., 3] zyx int coords (-1 rows = padding) -> [...] int32 keys."""
    d, h, w = shape_zyx
    c = coords_zyx.to(torch.int64)
    z, y, x = c[..., 0], c[..., 1], c[..., 2]
    keys = (z * h + y) * w + x
    return torch.where(z >= 0, keys, INVALID_KEY).to(torch.int32)


def host_plan(arr: torch.Tensor) -> SubmPlan:
    """[B, 27, cap] host plan (-1 = missing; int16 or int32) -> SubmPlan."""
    return SubmPlan(torch.clamp(arr, min=0).to(torch.int64), arr >= 0)


def flatten_plan(plan: SubmPlan, rows_in: int) -> SubmPlan:
    """[B, K, M] batched plan -> [K, B*M] plan over concatenated rows.

    rows_in: per-sample row count of the level the indices point INTO
    (M for subm plans; the input level's cap for stride plans).
    """
    b, k, m = plan.idx.shape
    off = (torch.arange(b, dtype=plan.idx.dtype, device=plan.idx.device)
           * rows_in)[:, None, None]
    idx = (plan.idx + off).transpose(0, 1).reshape(k, b * m)
    found = plan.found.transpose(0, 1).reshape(k, b * m)
    return SubmPlan(idx, found)


def gather_im2col(feats: torch.Tensor, plan: SubmPlan) -> torch.Tensor:
    """[M_in, C] features + [K, M] plan -> [M, K*C] im2col (missing -> 0)."""
    k, m = plan.idx.shape
    g = torch.index_select(feats, 0, plan.idx.reshape(-1)).reshape(k, m, -1)
    g = torch.where(plan.found[..., None], g, 0.0)
    return g.transpose(0, 1).reshape(m, -1)


def subm_conv(feats: torch.Tensor, weight: torch.Tensor,
              plan: SubmPlan) -> torch.Tensor:
    """Gather-GEMM sparse conv: [M_in, Cin] x [K, Cin, Cout] -> [M, Cout]."""
    k, cin, cout = weight.shape
    return gather_im2col(feats, plan) @ weight.reshape(k * cin, cout)


def subm_conv_batched(feats: torch.Tensor, weight: torch.Tensor,
                      plan: SubmPlan) -> torch.Tensor:
    """subm_conv over a batch as one flat gather-GEMM.

    feats: [B, M_in, C]; plan: batched [B, K, M_out] with indices into the
    input rows (a subm plan, or a stride plan into the previous level).
    Returns [B, M_out, Cout].
    """
    b, m_in, c = feats.shape
    m_out = plan.idx.shape[-1]
    out = subm_conv(feats.reshape(b * m_in, c), weight,
                    flatten_plan(plan, m_in))
    return out.reshape(b, m_out, -1)


def to_dense(keys: torch.Tensor, feats: torch.Tensor,
             shape_zyx: Tuple[int, int, int]) -> torch.Tensor:
    """Scatter active rows into a dense [B, D, H, W, C] canvas.

    keys: [B, M]; feats: [B, M, C]. Padding rows land in one extra trash
    row that is cut off, so the scatter needs no data-dependent shape.
    """
    b, m, c = feats.shape
    n = shape_zyx[0] * shape_zyx[1] * shape_zyx[2]
    base = torch.arange(b, device=keys.device)[:, None] * n
    flat = torch.where(keys != INVALID_KEY, base + keys.to(torch.int64),
                       b * n)
    canvas = feats.new_zeros((b * n + 1, c))
    canvas.index_put_((flat.reshape(-1),), feats.reshape(b * m, c))
    return canvas[:b * n].reshape(b, *shape_zyx, c)


def out_shape_stride2(shape_zyx: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """Output dims of a kernel-3, stride-2, pad-1 conv: (D-1)//2 + 1."""
    return tuple((s - 1) // 2 + 1 for s in shape_zyx)
