"""Sparse 3D convolution over gather plans, and the rulebook that makes
the plans on the device.

Active voxels of a level live in fixed-capacity, key-sorted row arrays:
``keys [M]`` (linear zyx, INVALID_KEY padded) and ``feats [M, C]``. A
plan ``[27, M]`` holds, for each output row and kernel tap (dz, dy, dx
row-major over {-1, 0, 1}), the input row of the neighbour, or -1 where it
is missing: the host rulebook's wire format, int16 or int32, batched as
``[B, 27, M]``. A convolution gathers the 27 neighbour rows (missing ones
are zero) and multiplies them by the [27, Cin, Cout] weight.

Batches run flat: the per-sample segments are concatenated along rows and
each sample's plan indices are offset by b * rows_in, so every conv is one
gather-GEMM over the whole batch. Plans are built per sample, so rows of
another sample are never marked found.

Kernels (``sassd_tpu_torch/csrc``), each beside its plain PyTorch version,
which a wrapper takes only for CPU tensors:

- K4 ``subm_conv_batched``: the gather-GEMM (``sparse_conv.cu``), which
  also computes the input gradients of the trained convs;
- K10 ``conv_weight_grad``: their weight gradients (``sparse_conv_bwd.cu``);
- K5 ``densify_nchw``: the last level into the dense tail's NCHW canvas,
  and K5b its backward (``densify.cu``);
- K6 ``build_index_map`` + ``window_plan``: the device rulebook's dense
  key -> row maps and the plans resolved through them
  (``device_plans.cu``);
- K7 ``downsample_keys``: the sorted, capped active set of a stride-2
  level (``downsample.cu``).

Training differentiates the convs through :func:`subm_conv_sym` and
:func:`stride_conv_hostT` (autograd Functions whose forward is K4 and whose
backward is K4 for the input gradient and K10 for the weight gradient) and
the dense tail's entry through :func:`densify_nchw` (K5, K5b). On CPU
tensors each is its plain forward under ordinary autograd.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from . import cuda

INVALID_KEY = torch.iinfo(torch.int32).max

_K4 = cuda.Kernel("sassd_sparse_conv",
                  [cuda.P, cuda.I, cuda.I, cuda.P, cuda.I, cuda.I, cuda.I,
                   cuda.P, cuda.I, cuda.P])
_K5 = cuda.Kernel("sassd_densify",
                  [cuda.P, cuda.P, cuda.I, cuda.I, cuda.I, cuda.I, cuda.I,
                   cuda.I, cuda.P, cuda.P])
_K5B = cuda.Kernel("sassd_densify_bwd",
                   [cuda.P, cuda.P, cuda.I, cuda.I, cuda.I, cuda.I, cuda.I,
                    cuda.I, cuda.P])
_K10 = cuda.Kernel("sassd_sparse_conv_dw",
                   [cuda.P, cuda.I, cuda.I, cuda.P, cuda.I, cuda.I, cuda.I,
                    cuda.P, cuda.I, cuda.I, cuda.P, cuda.P])
# output rows per K10 block: each block writes one [Cin, Cout] partial per
# tap, which a second pass sums in chunk order
K10_CHUNK_ROWS = 512
_K6_MAP = cuda.Kernel("sassd_index_map",
                      [cuda.P, cuda.I, cuda.I, cuda.L, cuda.P])
_K6_PLAN = cuda.Kernel("sassd_window_plan",
                       [cuda.P, cuda.I, cuda.I, cuda.I, cuda.I, cuda.I,
                        cuda.P, cuda.I, cuda.I, cuda.I, cuda.P])
_K7_CANDS = cuda.Kernel("sassd_downsample_candidates",
                        [cuda.P, cuda.I, cuda.I, cuda.I, cuda.I, cuda.I,
                         cuda.I, cuda.I, cuda.P])
_K7_UNIQUE = cuda.Kernel("sassd_unique_sorted",
                         [cuda.P, cuda.I, cuda.I, cuda.I, cuda.P])
# the C entry points of each kernel id, for launch counts
KERNEL_SYMBOLS = {
    "K4": ("sassd_sparse_conv",),
    "K5": ("sassd_densify",),
    "K5b": ("sassd_densify_bwd",),
    "K10": ("sassd_sparse_conv_dw",),
    "K6": ("sassd_index_map", "sassd_window_plan"),
    "K7": ("sassd_downsample_candidates", "sassd_unique_sorted"),
}

# tap groups (dz, dy) of the 27-tap order, each covering dx = -1, 0, 1
_DZ = (-1, -1, -1, 0, 0, 0, 1, 1, 1)
_DY = (-1, 0, 1, -1, 0, 1, -1, 0, 1)


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


def keys_to_coords(keys: torch.Tensor,
                   shape_zyx: Tuple[int, int, int]) -> torch.Tensor:
    """[...] int32 keys -> [..., 3] int32 zyx coords (INVALID -> -1)."""
    d, h, w = shape_zyx
    coords = torch.stack([keys // (w * h), (keys // w) % h, keys % w], -1)
    return torch.where((keys != INVALID_KEY)[..., None], coords,
                       -1).to(torch.int32)


def host_plan(arr: torch.Tensor) -> SubmPlan:
    """[B, 27, cap] plan (-1 = missing; int16 or int32) -> SubmPlan."""
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


def subm_conv_batched_plain(feats: torch.Tensor, weight: torch.Tensor,
                            plan: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4 (see subm_conv_batched)."""
    b, m_in, c = feats.shape
    m_out = plan.shape[-1]
    out = subm_conv(feats.reshape(b * m_in, c), weight,
                    flatten_plan(host_plan(plan), m_in))
    return out.reshape(b, m_out, -1)


def subm_conv_batched(feats: torch.Tensor, weight: torch.Tensor,
                      plan: torch.Tensor) -> torch.Tensor:
    """Sparse conv over a batch as one flat gather-GEMM (K4 on the card).

    feats: [B, M_in, Cin] float32; weight: [27, Cin, Cout]; plan: the
    wire-format [B, 27, M_out] int16/int32 plan (-1 = missing) with rows
    into each sample's M_in input rows (a subm plan, or a stride plan into
    the previous level). Returns [B, M_out, Cout].
    """
    if feats.device.type == "cpu":
        return subm_conv_batched_plain(feats, weight, plan)
    cuda.check_cuda("feats", feats, torch.float32, 3)
    cuda.check_cuda("weight", weight, torch.float32, 3)
    if plan.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"plan must be int16 or int32, got {plan.dtype}")
    cuda.check_cuda("plan", plan, plan.dtype, 3)
    b, m_in, cin = feats.shape
    m_out = plan.shape[2]
    cout = weight.shape[2]
    if plan.shape[:2] != (b, 27) or weight.shape[:2] != (27, cin):
        raise ValueError(f"plan {tuple(plan.shape)} / weight "
                         f"{tuple(weight.shape)} do not fit feats "
                         f"{tuple(feats.shape)}")
    if cin % 4 or cin > 64 or cout not in (16, 32, 64):
        raise ValueError(f"K4 takes Cin a multiple of 4 up to 64 and Cout "
                         f"16, 32 or 64, got {cin} -> {cout}")
    if feats.data_ptr() % 16:
        raise ValueError("feats must be 16-byte aligned (float4 loads)")
    with torch.cuda.device(feats.device):
        out = torch.empty((b, m_out, cout), dtype=torch.float32,
                          device=feats.device)
        _K4.launch(feats.data_ptr(), m_in, cin, plan.data_ptr(),
                   int(plan.dtype == torch.int16), b, m_out,
                   weight.data_ptr(), cout, out.data_ptr())
    return out


def conv_weight_grad_plain(feats: torch.Tensor, plan: torch.Tensor,
                           d_out: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K10 (see conv_weight_grad)."""
    b, m_in, cin = feats.shape
    col = gather_im2col(feats.reshape(b * m_in, cin),
                        flatten_plan(host_plan(plan), m_in))
    dw = col.T @ d_out.reshape(-1, d_out.shape[-1])
    return dw.reshape(27, cin, -1)


def conv_weight_grad(feats: torch.Tensor, plan: torch.Tensor,
                     d_out: torch.Tensor) -> torch.Tensor:
    """dW = im2col(feats, plan)^T . d_out of a sparse conv (K10 on the
    card; the im2col is never built there).

    feats: [B, M_in, Cin] float32, the conv's input; plan: its wire-format
    [B, 27, M_out] plan; d_out: [B, M_out, Cout]. Returns [27, Cin, Cout].
    """
    if feats.device.type == "cpu":
        return conv_weight_grad_plain(feats, plan, d_out)
    cuda.check_cuda("feats", feats, torch.float32, 3)
    cuda.check_cuda("d_out", d_out, torch.float32, 3)
    if plan.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"plan must be int16 or int32, got {plan.dtype}")
    cuda.check_cuda("plan", plan, plan.dtype, 3)
    b, m_in, cin = feats.shape
    m_out, cout = d_out.shape[1], d_out.shape[2]
    if plan.shape != (b, 27, m_out) or d_out.shape[0] != b:
        raise ValueError(f"plan {tuple(plan.shape)} / d_out "
                         f"{tuple(d_out.shape)} do not fit feats "
                         f"{tuple(feats.shape)}")
    if cin % 4 or cout % 4 or cin > 64 or cout > 64:
        raise ValueError(f"K10 takes Cin and Cout multiples of 4 up to 64, "
                         f"got {cin} -> {cout}")
    if feats.data_ptr() % 16 or d_out.data_ptr() % 16:
        raise ValueError("feats and d_out must be 16-byte aligned")
    chunks = -(-(b * m_out) // K10_CHUNK_ROWS)
    with torch.cuda.device(feats.device):
        partial = torch.empty((max(chunks, 1), 27, cin, cout),
                              dtype=torch.float32, device=feats.device)
        dw = torch.empty((27, cin, cout), dtype=torch.float32,
                         device=feats.device)
        _K10.launch(feats.data_ptr(), m_in, cin, plan.data_ptr(),
                    int(plan.dtype == torch.int16), b, m_out,
                    d_out.data_ptr(), cout, K10_CHUNK_ROWS,
                    partial.data_ptr(), dw.data_ptr())
    return dw


class _SubmConvFn(torch.autograd.Function):
    """Submanifold conv on the card: forward K4; backward K4 for d_feats
    (the same plan, taps reversed, weights transposed: the plan is
    symmetric) and K10 for d_weight."""

    @staticmethod
    def forward(ctx, feats, weight, plan):
        ctx.save_for_backward(feats, weight, plan)
        return subm_conv_batched(feats, weight, plan)

    @staticmethod
    def backward(ctx, d_out):
        feats, weight, plan = ctx.saved_tensors
        d_out = d_out.contiguous()
        d_feats = d_w = None
        if ctx.needs_input_grad[0]:
            w_rev = weight.flip(0).transpose(1, 2).contiguous()
            d_feats = subm_conv_batched(d_out, w_rev, plan)
        if ctx.needs_input_grad[1]:
            d_w = conv_weight_grad(feats, plan, d_out)
        return d_feats, d_w, None


class _StrideConvTFn(torch.autograd.Function):
    """Stride-2 conv on the card: forward K4 on the stride plan; backward
    K4 on the transpose plan with the transposed weights for d_feats, K10
    on the stride plan for d_weight."""

    @staticmethod
    def forward(ctx, feats, weight, plan, plan_t):
        ctx.save_for_backward(feats, weight, plan, plan_t)
        return subm_conv_batched(feats, weight, plan)

    @staticmethod
    def backward(ctx, d_out):
        feats, weight, plan, plan_t = ctx.saved_tensors
        d_out = d_out.contiguous()
        d_feats = d_w = None
        if ctx.needs_input_grad[0]:
            d_feats = subm_conv_batched(
                d_out, weight.transpose(1, 2).contiguous(), plan_t)
        if ctx.needs_input_grad[1]:
            d_w = conv_weight_grad(feats, plan, d_out)
        return d_feats, d_w, None, None


def subm_conv_sym(feats: torch.Tensor, weight: torch.Tensor,
                  plan: torch.Tensor) -> torch.Tensor:
    """Differentiable submanifold conv over a batch: [B, M, Cin] features,
    [27, Cin, Cout] weight and the level's [B, 27, M] subm plan ->
    [B, M, Cout]. The plan must be symmetric (input set = output set)."""
    if feats.device.type == "cpu":
        return subm_conv_batched_plain(feats, weight, plan)
    return _SubmConvFn.apply(feats, weight, plan)


def stride_conv_hostT(feats: torch.Tensor, weight: torch.Tensor,
                      plan: torch.Tensor, plan_t: torch.Tensor) -> torch.Tensor:
    """Differentiable stride-2 conv over a batch: [B, M_in, Cin] features,
    the [B, 27, M_out] stride plan into the input level and its [B, 27,
    M_in] transpose plan into the output level (the host rulebook's
    strideT) -> [B, M_out, Cout]."""
    if feats.device.type == "cpu":
        return subm_conv_batched_plain(feats, weight, plan)
    return _StrideConvTFn.apply(feats, weight, plan, plan_t)


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


def densify_nchw_plain(keys: torch.Tensor, feats: torch.Tensor,
                       shape_zyx: Tuple[int, int, int]):
    """Plain PyTorch version of K5 (see densify_nchw)."""
    d, h, w = shape_zyx
    b, _, c = feats.shape
    xd = to_dense(keys, feats, shape_zyx)                  # [B,D,H,W,C]
    occ = to_dense(keys, torch.ones_like(feats[..., :1]), shape_zyx)
    occ = (occ[..., 0] > 0).to(feats.dtype)[:, :, None]    # [B,D,1,H,W]
    return xd.permute(0, 1, 4, 2, 3).reshape(b, d * c, h, w), occ


def densify_nchw(keys: torch.Tensor, feats: torch.Tensor,
                 shape_zyx: Tuple[int, int, int]):
    """Active rows -> the dense tail's canvas and occupancy (K5 on the
    card, K5b for the gradient of the canvas).

    keys: [B, M] int32; feats: [B, M, C] float32. Returns the
    [B, D*C, H, W] canvas, channel z*C + c (the d-major order of the JAX
    package's densify_bev), and the [B, D, 1, H, W] float occupancy.
    """
    if feats.device.type == "cpu":
        return densify_nchw_plain(keys, feats, shape_zyx)
    return _DensifyFn.apply(keys, feats, tuple(shape_zyx))


def _densify_k5(keys: torch.Tensor, feats: torch.Tensor,
                shape_zyx: Tuple[int, int, int]):
    cuda.check_cuda("keys", keys, torch.int32, 2)
    cuda.check_cuda("feats", feats, torch.float32, 3)
    b, m, c = feats.shape
    if keys.shape != (b, m):
        raise ValueError(f"keys {tuple(keys.shape)} do not fit feats "
                         f"{tuple(feats.shape)}")
    d, h, w = shape_zyx
    with torch.cuda.device(feats.device):
        canvas = torch.zeros((b, d * c, h, w), dtype=torch.float32,
                             device=feats.device)
        occ = torch.zeros((b, d, 1, h, w), dtype=torch.float32,
                          device=feats.device)
        _K5.launch(keys.data_ptr(), feats.data_ptr(), b, m, c, d, h, w,
                   canvas.data_ptr(), occ.data_ptr())
    return canvas, occ


def densify_grad_plain(keys: torch.Tensor, d_canvas: torch.Tensor,
                       shape_zyx: Tuple[int, int, int]) -> torch.Tensor:
    """Plain PyTorch version of K5b (see densify_grad)."""
    d, h, w = shape_zyx
    b = keys.shape[0]
    return gather_rows(keys, d_canvas.reshape(b, d, -1, h, w))


def densify_grad(keys: torch.Tensor, d_canvas: torch.Tensor,
                 shape_zyx: Tuple[int, int, int]) -> torch.Tensor:
    """Gradient of densify_nchw's canvas with respect to its rows: [B, M]
    keys and the [B, D*C, H, W] canvas gradient -> [B, M, C], 0 on padding
    rows (K5b on the card)."""
    if d_canvas.device.type == "cpu":
        return densify_grad_plain(keys, d_canvas, shape_zyx)
    cuda.check_cuda("keys", keys, torch.int32, 2)
    cuda.check_cuda("d_canvas", d_canvas, torch.float32, 4)
    d, h, w = shape_zyx
    b, m = keys.shape
    if d_canvas.shape[0] != b or d_canvas.shape[1] % d \
            or d_canvas.shape[2:] != (h, w):
        raise ValueError(f"d_canvas {tuple(d_canvas.shape)} does not fit "
                         f"keys {tuple(keys.shape)} on {shape_zyx}")
    c = d_canvas.shape[1] // d
    with torch.cuda.device(keys.device):
        out = torch.empty((b, m, c), dtype=torch.float32, device=keys.device)
        _K5B.launch(keys.data_ptr(), d_canvas.data_ptr(), b, m, c, d, h, w,
                    out.data_ptr())
    return out


class _DensifyFn(torch.autograd.Function):
    """densify_nchw on the card: forward K5, backward K5b."""

    @staticmethod
    def forward(ctx, keys, feats, shape_zyx):
        canvas, occ = _densify_k5(keys, feats, shape_zyx)
        ctx.save_for_backward(keys)
        ctx.shape_zyx = shape_zyx
        ctx.mark_non_differentiable(occ)
        return canvas, occ

    @staticmethod
    def backward(ctx, d_canvas, _d_occ):
        (keys,) = ctx.saved_tensors
        d_feats = None
        if ctx.needs_input_grad[1]:
            d_feats = densify_grad(keys, d_canvas.contiguous(),
                                   ctx.shape_zyx)
        return None, d_feats, None


def gather_rows(keys: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
    """Rows of a dense [B, D, C, H, W] level at the [B, M] keys -> [B, M,
    C], 0 on padding rows: the aux branch's L3 rows (the JAX package's
    _gather_mid), a differentiable torch gather."""
    b, d, c, h, w = dense.shape
    rows = dense.permute(0, 1, 3, 4, 2).reshape(b, d * h * w, c)
    ok = keys != INVALID_KEY
    idx = torch.where(ok, keys.to(torch.int64), 0)
    got = torch.gather(rows, 1, idx[..., None].expand(-1, -1, c))
    return torch.where(ok[..., None], got, 0.0)


def out_shape_stride2(shape_zyx: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """Output dims of a kernel-3, stride-2, pad-1 conv: (D-1)//2 + 1."""
    return tuple((s - 1) // 2 + 1 for s in shape_zyx)


# ---------------------------------------------------------------------------
# the device rulebook: index maps, window plans, downsampled levels
# ---------------------------------------------------------------------------

def build_index_map_plain(keys: torch.Tensor,
                          shape_zyx: Tuple[int, int, int]) -> torch.Tensor:
    """Plain PyTorch version of K6's map (see build_index_map)."""
    b, m = keys.shape
    total = shape_zyx[0] * shape_zyx[1] * shape_zyx[2]
    flat = torch.full((b * total + 1,), -1, dtype=torch.int32,
                      device=keys.device)
    base = torch.arange(b, device=keys.device)[:, None] * total
    ok = (keys >= 0) & (keys < total)
    idx = torch.where(ok, base + keys.to(torch.int64), b * total)
    rows = torch.arange(m, dtype=torch.int32, device=keys.device)
    flat[idx.reshape(-1)] = rows.repeat(b)
    return flat[:b * total].view(b, total)


def build_index_map(keys: torch.Tensor,
                    shape_zyx: Tuple[int, int, int]) -> torch.Tensor:
    """[B, M] unique keys -> [B, D*H*W] int32 map: key -> row, -1 = empty.

    K6 on the card. At the car config's full-resolution grid the map is
    90.1M cells, 360 MB per sample; it is made on the keys' device.
    """
    if keys.device.type == "cpu":
        return build_index_map_plain(keys, shape_zyx)
    cuda.check_cuda("keys", keys, torch.int32, 2)
    b, m = keys.shape
    total = shape_zyx[0] * shape_zyx[1] * shape_zyx[2]
    with torch.cuda.device(keys.device):
        out = torch.empty((b, total), dtype=torch.int32, device=keys.device)
        _K6_MAP.launch(keys.data_ptr(), b, m, total, out.data_ptr())
    return out


def window_plan_plain(out_keys: torch.Tensor,
                      out_shape: Tuple[int, int, int],
                      index_map: torch.Tensor,
                      in_shape: Tuple[int, int, int],
                      scale: int) -> torch.Tensor:
    """Plain PyTorch version of K6's plan (see window_plan)."""
    d, h, w = in_shape
    b, m = out_keys.shape
    dev = out_keys.device
    c = keys_to_coords(out_keys, out_shape).to(torch.int64) * scale
    z, y, x = (c[..., i].unsqueeze(1) for i in range(3))     # [B, 1, M]
    zq = z + torch.tensor(_DZ, device=dev)[None, :, None]    # [B, 9, M]
    yq = y + torch.tensor(_DY, device=dev)[None, :, None]
    gok = ((x >= 0) & (x < w) & (zq >= 0) & (zq < d)
           & (yq >= 0) & (yq < h))
    q = (zq * h + yq) * w + x
    flat = index_map.reshape(-1)
    base = torch.arange(b, device=dev)[:, None, None] * (d * h * w)

    def look(qj, ok):
        return torch.where(ok, flat[torch.where(ok, base + qj, 0)], -1)

    plan = torch.stack([look(q - 1, gok & (x >= 1)), look(q, gok),
                        look(q + 1, gok & (x + 1 < w))], 2)  # [B, 9, 3, M]
    return plan.reshape(b, 27, m).to(torch.int32)


def window_plan(out_keys: torch.Tensor, out_shape: Tuple[int, int, int],
                index_map: torch.Tensor, in_shape: Tuple[int, int, int],
                scale: int) -> torch.Tensor:
    """27-tap plans of the output rows through the input level's map.

    out_keys: [B, M_out] keys on `out_shape`; index_map: [B, D*H*W] of the
    input level on `in_shape`. Output row m's base cell is scale * its
    coords (scale 1: submanifold plan, out_shape == in_shape; scale 2:
    stride-2 plan into the previous level). Returns the wire-format
    [B, 27, M_out] int32 plan, -1 = missing or off the input grid. K6 on
    the card.
    """
    if out_keys.device.type == "cpu":
        return window_plan_plain(out_keys, out_shape, index_map, in_shape,
                                 scale)
    cuda.check_cuda("out_keys", out_keys, torch.int32, 2)
    cuda.check_cuda("index_map", index_map, torch.int32, 2)
    b, m = out_keys.shape
    d, h, w = in_shape
    if index_map.shape != (b, d * h * w):
        raise ValueError(f"index_map {tuple(index_map.shape)} is not "
                         f"[{b}, {d * h * w}]")
    with torch.cuda.device(out_keys.device):
        plan = torch.empty((b, 27, m), dtype=torch.int32,
                           device=out_keys.device)
        _K6_PLAN.launch(out_keys.data_ptr(), b, m, out_shape[1],
                        out_shape[2], scale, index_map.data_ptr(), d, h, w,
                        plan.data_ptr())
    return plan


def downsample_candidates(keys: torch.Tensor,
                          shape_zyx: Tuple[int, int, int]) -> torch.Tensor:
    """[B, M] keys -> [B, 8*M] parent keys of a stride-2 k3 p1 conv
    (INVALID_KEY for padding rows and parents off the output grid)."""
    od, oh, ow = out_shape_stride2(shape_zyx)
    c = keys_to_coords(keys, shape_zyx)
    c0, c1 = c // 2, (c + 1) // 2
    valid = c[..., 0] >= 0
    cands = []
    for sz in range(2):
        for sy in range(2):
            for sx in range(2):
                z = (c1 if sz else c0)[..., 0]
                y = (c1 if sy else c0)[..., 1]
                x = (c1 if sx else c0)[..., 2]
                ok = valid & (z < od) & (y < oh) & (x < ow)
                cands.append(torch.where(ok, (z * oh + y) * ow + x,
                                         INVALID_KEY))
    return torch.cat(cands, 1).to(torch.int32)


def downsample_keys_plain(keys: torch.Tensor,
                          shape_zyx: Tuple[int, int, int],
                          cap: int) -> torch.Tensor:
    """Plain PyTorch version of K7 (see downsample_keys)."""
    s = torch.sort(downsample_candidates(keys, shape_zyx), dim=1).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    first &= s != INVALID_KEY
    rank = torch.cumsum(first.to(torch.int64), 1) - 1
    out = torch.full((s.shape[0], cap + 1), INVALID_KEY, dtype=torch.int32,
                     device=keys.device)
    out.scatter_(1, torch.where(first & (rank < cap), rank, cap), s)
    return out[:, :cap].contiguous()


def downsample_keys(keys: torch.Tensor, shape_zyx: Tuple[int, int, int],
                    cap: int) -> torch.Tensor:
    """Active set of a stride-2 k3 p1 conv: [B, M] keys on `shape_zyx` ->
    [B, cap] ascending keys on the output grid, INVALID_KEY padded; the
    lowest keys win the cap. K7 (around torch.sort) on the card."""
    if keys.device.type == "cpu":
        return downsample_keys_plain(keys, shape_zyx, cap)
    cuda.check_cuda("keys", keys, torch.int32, 2)
    b, m = keys.shape
    d, h, w = shape_zyx
    od, oh, ow = out_shape_stride2(shape_zyx)
    with torch.cuda.device(keys.device):
        cands = torch.empty((b, 8 * m), dtype=torch.int32,
                            device=keys.device)
        _K7_CANDS.launch(keys.data_ptr(), b, m, h, w, od, oh, ow,
                         cands.data_ptr())
        s = torch.sort(cands, dim=1).values
        out = torch.empty((b, cap), dtype=torch.int32, device=keys.device)
        _K7_UNIQUE.launch(s.data_ptr(), b, 8 * m, cap, out.data_ptr())
    return out


def device_rulebook(keys0: torch.Tensor,
                    level_shapes: Sequence[Tuple[int, int, int]],
                    level_caps: Sequence[int]) -> Dict[str, torch.Tensor]:
    """The backbone's rulebook built on the keys' device, in the host
    rulebook's format (data.kitti.build_host_plans without the plan_
    prefix): subm0..2 and stride1..3 [B, 27, capL] int32 plans, and
    coords1..3 [B, capL, 3] int32.

    keys0: [B, cap0] key-sorted level-0 keys; level_shapes: the four level
    grids; level_caps: the caps of levels 1..3. Level 3 gets no subm plan:
    the dense tail runs it.
    """
    plans = {}
    keys, shape = keys0, level_shapes[0]
    imap = build_index_map(keys, shape)
    plans["subm0"] = window_plan(keys, shape, imap, shape, 1)
    for lvl in (1, 2, 3):
        out_shape = level_shapes[lvl]
        out = downsample_keys(keys, shape, level_caps[lvl - 1])
        plans[f"stride{lvl}"] = window_plan(out, out_shape, imap, shape, 2)
        plans[f"coords{lvl}"] = keys_to_coords(out, out_shape)
        keys, shape = out, out_shape
        if lvl < 3:
            imap = build_index_map(keys, shape)
            plans[f"subm{lvl}"] = window_plan(keys, shape, imap, shape, 1)
    return plans
