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
  level, optionally with a per-row output-y limit (``downsample.cu``);
- K13 ``stride_plans_T`` and K14 ``aux_plans``: the rulebook's train-only
  plans, the stride convs' transpose plans and the aux branch's ring
  plans, each of its three levels in one launch (``device_plans.cu``).

Training differentiates the convs through :func:`subm_conv_sym` and
:func:`stride_conv_hostT` (autograd Functions whose forward is K4 and whose
backward is K4 for the input gradient and K10 for the weight gradient) and
the dense tail's entry through :func:`densify_nchw` (K5, K5b). On CPU
tensors each is its plain forward under ordinary autograd.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from . import cuda

INVALID_KEY = torch.iinfo(torch.int32).max

_K4 = cuda.Kernel("sassd_sparse_conv",
                  [cuda.P, cuda.I, cuda.I, cuda.P, cuda.I, cuda.I, cuda.I,
                   cuda.P, cuda.I, cuda.P])
_K5 = cuda.Kernel("sassd_densify",
                  [cuda.P, cuda.P, cuda.I, cuda.I, cuda.I, cuda.I, cuda.I,
                   cuda.I, cuda.P, cuda.P, cuda.P])
_K5B = cuda.Kernel("sassd_densify_bwd",
                   [cuda.P, cuda.P, cuda.I, cuda.I, cuda.I, cuda.I, cuda.I,
                    cuda.I, cuda.P])
_K10 = cuda.Kernel("sassd_sparse_conv_dw",
                   [cuda.P, cuda.I, cuda.I, cuda.P, cuda.I, cuda.I, cuda.I,
                    cuda.P, cuda.I, cuda.I, cuda.P, cuda.P, cuda.P, cuda.P,
                    cuda.P])
# K10's blocks: each multiplies an equal share of all taps' found rows and
# writes a [Cin, Cout] partial per tap it touches, which a last pass sums
# in block order (two blocks an SM of the H100's 132)
K10_BLOCKS = 264
_K6_MAP = cuda.Kernel("sassd_index_map",
                      [cuda.P, cuda.I, cuda.I, cuda.L, cuda.P])
_K6_PLAN = cuda.Kernel("sassd_window_plan",
                       [cuda.P, cuda.I, cuda.I, cuda.I, cuda.I, cuda.I,
                        cuda.P, cuda.I, cuda.I, cuda.I, cuda.P])
_K7 = cuda.Kernel("sassd_downsample",
                  [cuda.P, cuda.I, cuda.I, cuda.I, cuda.I, cuda.I, cuda.I,
                   cuda.I, cuda.I, cuda.P, cuda.I, cuda.P, cuda.P, cuda.I,
                   cuda.P])
# K7's bitmap tile: 1024 32-bit words (32,768 output cells) a block
K7_TILE_CELLS = 32768
_K13 = cuda.Kernel("sassd_stride_plans_t",
                   [cuda.P] * 6 + [cuda.I] * 16 + [cuda.P] * 3)
_K14 = cuda.Kernel("sassd_aux_plans",
                   [cuda.P, cuda.I, cuda.I, cuda.P, cuda.P, cuda.P]
                   + [cuda.I] * 9 + [cuda.P])
# the C entry points of each kernel id, for launch counts
KERNEL_SYMBOLS = {
    "K4": ("sassd_sparse_conv",),
    "K5": ("sassd_densify",),
    "K5b": ("sassd_densify_bwd",),
    "K10": ("sassd_sparse_conv_dw",),
    "K6": ("sassd_index_map", "sassd_window_plan"),
    "K7": ("sassd_downsample",),
    "K13": ("sassd_stride_plans_t",),
    "K14": ("sassd_aux_plans",),
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
    if feats.data_ptr() % 16 or weight.data_ptr() % 16:
        raise ValueError("feats and weight must be 16-byte aligned "
                         "(16-byte cp.async copies)")
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
    rows = b * m_out
    n_counts = 27 * b * -(-m_out // 1024)
    # one scratch buffer: counts, totals, the (input, output) row pairs
    # and the partials, each at a 16-byte offset
    offs = [0]
    for n in (4 * n_counts, 4 * 27, 8 * 27 * rows):
        offs.append(offs[-1] + -(-n // 16) * 16)
    size = offs[-1] + 4 * (K10_BLOCKS + 27) * cin * cout
    with torch.cuda.device(feats.device):
        work = torch.empty(size, dtype=torch.uint8, device=feats.device)
        dw = torch.empty((27, cin, cout), dtype=torch.float32,
                         device=feats.device)
        base = work.data_ptr()
        _K10.launch(feats.data_ptr(), m_in, cin, plan.data_ptr(),
                    int(plan.dtype == torch.int16), b, m_out,
                    d_out.data_ptr(), cout, K10_BLOCKS, *(base + o for o in
                                                          offs),
                    dw.data_ptr())
    return dw


def _subm_input_grad(d_out: torch.Tensor, weight: torch.Tensor,
                     plan: torch.Tensor) -> torch.Tensor:
    """d_feats of a submanifold conv: K4 on the same (symmetric) plan with
    the taps reversed and the weight transposed, [27, Cout, Cin]. K4
    writes 16, 32 or 64 channels; an input narrower than 16 (the point
    features under the PointNet VFE, whose parameters need this
    gradient) gets zero weight columns up to 16, and its first Cin
    output channels are kept."""
    w_rev = weight.flip(0).transpose(1, 2)
    cin = w_rev.shape[2]
    pad = 16 - cin if cin < 16 else 0
    if pad:
        w_rev = torch.nn.functional.pad(w_rev, (0, pad))
    d_feats = subm_conv_batched(d_out, w_rev.contiguous(), plan)
    return d_feats[..., :cin] if pad else d_feats


class _SubmConvFn(torch.autograd.Function):
    """Submanifold conv on the card: forward K4; backward K4 for d_feats
    (the same plan, taps reversed, weights transposed: the plan is
    symmetric; see _subm_input_grad) and K10 for d_weight."""

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
            d_feats = _subm_input_grad(d_out, weight, plan)
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
        # K5 writes every element of both outputs; the row map is scratch
        row_map = torch.empty((b, d * h * w), dtype=torch.int32,
                              device=feats.device)
        canvas = torch.empty((b, d * c, h, w), dtype=torch.float32,
                             device=feats.device)
        occ = torch.empty((b, d, 1, h, w), dtype=torch.float32,
                          device=feats.device)
        _K5.launch(keys.data_ptr(), feats.data_ptr(), b, m, c, d, h, w,
                   row_map.data_ptr(), canvas.data_ptr(), occ.data_ptr())
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
    return _densify_k5b(keys, d_canvas, shape_zyx)


def _densify_k5b(keys: torch.Tensor, d_canvas: torch.Tensor,
                 shape_zyx: Tuple[int, int, int]) -> torch.Tensor:
    """K5b on `keys` already checked (by densify_grad, or by K5's wrapper
    in the forward whose backward this is); checks d_canvas."""
    cuda.check_cuda("d_canvas", d_canvas, torch.float32, 4)
    d, h, w = shape_zyx
    b, m = keys.shape
    nb, dc, hh, ww = d_canvas.shape
    if nb != b or dc % d or hh != h or ww != w:
        raise ValueError(f"d_canvas {tuple(d_canvas.shape)} does not fit "
                         f"keys {tuple(keys.shape)} on {shape_zyx}")
    out = torch.empty((b, m, dc // d), dtype=torch.float32,
                      device=keys.device)
    with torch.cuda.device(keys.device):
        _K5B.launch(keys.data_ptr(), d_canvas.data_ptr(), b, m, dc // d, d,
                    h, w, out.data_ptr())
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
            d_feats = _densify_k5b(keys, d_canvas.contiguous(),
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


def _window_lookup_plain(c: torch.Tensor, index_map: torch.Tensor,
                         in_shape: Tuple[int, int, int]) -> torch.Tensor:
    """[B, M, 3] int64 zyx base cells (negative = padding) -> the [B, 27,
    M] int32 plan of their 3x3x3 windows through the [B, D*H*W] map."""
    d, h, w = in_shape
    b, m = c.shape[:2]
    dev = c.device
    z, y, x = (c[..., i].unsqueeze(1) for i in range(3))     # [B, 1, M]
    zq = z + torch.tensor(_DZ, device=dev)[None, :, None]    # [B, 9, M]
    yq = y + torch.tensor(_DY, device=dev)[None, :, None]
    gok = ((z >= 0) & (x >= 0) & (x < w) & (zq >= 0) & (zq < d)
           & (yq >= 0) & (yq < h))
    q = (zq * h + yq) * w + x
    flat = index_map.reshape(-1)
    base = torch.arange(b, device=dev)[:, None, None] * (d * h * w)

    def look(qj, ok):
        return torch.where(ok, flat[torch.where(ok, base + qj, 0)], -1)

    plan = torch.stack([look(q - 1, gok & (x >= 1)), look(q, gok),
                        look(q + 1, gok & (x + 1 < w))], 2)  # [B, 9, 3, M]
    return plan.reshape(b, 27, m).to(torch.int32)


def window_plan_plain(out_keys: torch.Tensor,
                      out_shape: Tuple[int, int, int],
                      index_map: torch.Tensor,
                      in_shape: Tuple[int, int, int],
                      scale: int) -> torch.Tensor:
    """Plain PyTorch version of K6's plan (see window_plan)."""
    c = keys_to_coords(out_keys, out_shape).to(torch.int64) * scale
    return _window_lookup_plain(c, index_map, in_shape)


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


def _stride_T_plain(keys: torch.Tensor, index_map: torch.Tensor,
                    in_shape: Tuple[int, int, int],
                    out_shape: Tuple[int, int, int]) -> torch.Tensor:
    """One level of stride_plans_T_plain: [B, M] input keys -> [B, 27, M]."""
    d, h, w = in_shape
    od, oh, ow = out_shape
    b, m = keys.shape
    dev = keys.device
    k = keys.to(torch.int64)
    ok = (k >= 0) & (k < d * h * w)
    k = torch.where(ok, k, 0)
    offs = torch.tensor((-1, 0, 1), device=dev)[None, :, None]

    def parents(c, n):          # [B, M] -> parents, live: [B, 3, M] each
        q = c[:, None, :] - offs
        return q // 2, (q >= 0) & (q % 2 == 0) & (q // 2 < n)
    pz, lz = parents(k // (h * w), od)
    py, ly = parents((k // w) % h, oh)
    px, lx = parents(k % w, ow)
    lin = ((pz[:, :, None, None] * oh + py[:, None, :, None]) * ow
           + px[:, None, None, :])                          # [B, 3, 3, 3, M]
    live = (ok[:, None, None, None] & lz[:, :, None, None]
            & ly[:, None, :, None] & lx[:, None, None, :])
    base = torch.arange(b, device=dev)[:, None, None, None, None] * (
        od * oh * ow)
    flat = index_map.reshape(-1)
    rows = torch.where(live, flat[torch.where(live, base + lin, 0)], -1)
    return rows.reshape(b, 27, m).to(torch.int32)


def stride_plans_T_plain(keys: Sequence[torch.Tensor],
                         maps: Sequence[torch.Tensor],
                         shapes: Sequence[Tuple[int, int, int]]
                         ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of K13 (see stride_plans_T)."""
    return tuple(_stride_T_plain(keys[lvl], maps[lvl], shapes[lvl],
                                 shapes[lvl + 1]) for lvl in range(3))


def stride_plans_T(keys: Sequence[torch.Tensor],
                   maps: Sequence[torch.Tensor],
                   shapes: Sequence[Tuple[int, int, int]]
                   ) -> Tuple[torch.Tensor, ...]:
    """Transpose plans of the three stride-2 k3 p1 convs: the [B, M_L]
    int32 keys of levels 0-2, the [B, D*H*W] index maps of levels 1-3 and
    the four level grids (each the stride-2 output of the one before) ->
    (strideT1, strideT2, strideT3), level L's [B, 27, M_{L-1}] int32: for
    input row i and tap k (dz, dy, dx row-major), the output row that
    reads it, the map's row at (cell - offset) / 2 where that is an
    integer cell on level L's grid, -1 = none. The host rulebook's
    ``strideT`` plans. K13 on the card, one launch for the three levels."""
    if keys[0].device.type == "cpu":
        return stride_plans_T_plain(keys, maps, shapes)
    if len(keys) != 3 or len(maps) != 3 or len(shapes) != 4:
        raise ValueError(f"{len(keys)} keys, {len(maps)} maps and "
                         f"{len(shapes)} grids: want 3, 3 and 4")
    b, card = keys[0].shape[0], keys[0].get_device()
    outs = []
    for lvl, key, imap, (d, h, w), (od, oh, ow) in zip(
            range(3), keys, maps, shapes, shapes[1:]):
        cuda.check_cuda(f"keys[{lvl}]", key, torch.int32, 2)
        cuda.check_cuda(f"maps[{lvl}]", imap, torch.int32, 2)
        if (od, oh, ow) != ((d - 1) // 2 + 1, (h - 1) // 2 + 1,
                            (w - 1) // 2 + 1):
            raise ValueError(f"grid {(od, oh, ow)} is not the stride-2 "
                             f"output of {(d, h, w)}")
        if key.shape[0] != b or imap.shape != (b, od * oh * ow):
            raise ValueError(f"keys[{lvl}] {tuple(key.shape)} and maps[{lvl}] "
                             f"{tuple(imap.shape)} do not fit batch {b} "
                             f"and grid {(od, oh, ow)}")
        if key.get_device() != card or imap.get_device() != card:
            raise ValueError("keys and maps must be on one card")
        outs.append(key.new_empty((b, 27, key.shape[1])))
    _K13.launch_on(keys[0], keys[0].data_ptr(), keys[1].data_ptr(),
                   keys[2].data_ptr(), maps[0].data_ptr(), maps[1].data_ptr(),
                   maps[2].data_ptr(), b, keys[0].shape[1], keys[1].shape[1],
                   keys[2].shape[1], *shapes[0], *shapes[1], *shapes[2],
                   *shapes[3], outs[0].data_ptr(), outs[1].data_ptr(),
                   outs[2].data_ptr())
    return tuple(outs)


def aux_plans_plain(cell0: torch.Tensor, maps: Sequence[torch.Tensor],
                    shapes: Sequence[Tuple[int, int, int]]) -> torch.Tensor:
    """Plain PyTorch version of K14 (see aux_plans): the three levels'
    plans stacked as the kernel writes them."""
    c = cell0.to(torch.int64)
    return torch.stack([_window_lookup_plain(c >> lvl, imap, shape)
                        for lvl, imap, shape in zip((1, 2, 3), maps, shapes)])


def aux_plans(cell0: torch.Tensor, maps: Sequence[torch.Tensor],
              shapes: Sequence[Tuple[int, int, int]]) -> torch.Tensor:
    """Aux-branch ring plans of levels 1-3: [B, M0, 3] int32 level-0 zyx
    cells (-1 = padding), the three levels' [B, D*H*W] index maps and
    their (D, H, W) grids -> [3, B, 27, M0] int32, level L at [L - 1]
    (a contiguous view in the host rulebook's ``aux{L}`` format): the rows
    of the 3x3x3 neighbourhood of cell0 >> L (taps (dz, dy, dx)
    row-major), -1 = missing. K14 on the card, one launch for the three
    levels."""
    if cell0.device.type == "cpu":
        return aux_plans_plain(cell0, maps, shapes)
    cuda.check_cuda("cell0", cell0, torch.int32, 3)
    b, m0, k = cell0.shape
    if k != 3 or len(maps) != 3 or len(shapes) != 3:
        raise ValueError(f"cell0 {tuple(cell0.shape)} with {len(maps)} maps "
                         f"and {len(shapes)} shapes: want [B, M0, 3] and 3")
    for lvl, imap, (d, h, w) in zip((1, 2, 3), maps, shapes):
        cuda.check_cuda(f"maps[{lvl - 1}]", imap, torch.int32, 2)
        if imap.shape != (b, d * h * w):
            raise ValueError(f"level {lvl}'s map {tuple(imap.shape)} is not "
                             f"[{b}, {d * h * w}]")
    plan = cell0.new_empty((3, b, 27, m0))
    _K14.launch_on(cell0, cell0.data_ptr(), b, m0, maps[0].data_ptr(),
                   maps[1].data_ptr(), maps[2].data_ptr(), *shapes[0],
                   *shapes[1], *shapes[2], plan.data_ptr())
    return plan


def downsample_candidates(keys: torch.Tensor,
                          shape_zyx: Tuple[int, int, int],
                          y_limit: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """[B, M] keys -> [B, 8*M] parent keys of a stride-2 k3 p1 conv
    (INVALID_KEY for padding rows and parents off the output grid, or at
    output y >= y_limit[b] where the [B] int32 limit is given)."""
    od, oh, ow = out_shape_stride2(shape_zyx)
    c = keys_to_coords(keys, shape_zyx)
    c0, c1 = c // 2, (c + 1) // 2
    valid = c[..., 0] >= 0
    y_hi = oh if y_limit is None else torch.clamp(y_limit, max=oh)[:, None]
    cands = []
    for sz in range(2):
        for sy in range(2):
            for sx in range(2):
                z = (c1 if sz else c0)[..., 0]
                y = (c1 if sy else c0)[..., 1]
                x = (c1 if sx else c0)[..., 2]
                ok = valid & (z < od) & (y < y_hi) & (x < ow)
                cands.append(torch.where(ok, (z * oh + y) * ow + x,
                                         INVALID_KEY))
    return torch.cat(cands, 1).to(torch.int32)


def downsample_keys_plain(keys: torch.Tensor,
                          shape_zyx: Tuple[int, int, int], cap: int,
                          y_limit: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain PyTorch version of K7 (see downsample_keys)."""
    s = torch.sort(downsample_candidates(keys, shape_zyx, y_limit),
                   dim=1).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    first &= s != INVALID_KEY
    rank = torch.cumsum(first.to(torch.int64), 1) - 1
    out = torch.full((s.shape[0], cap + 1), INVALID_KEY, dtype=torch.int32,
                     device=keys.device)
    out.scatter_(1, torch.where(first & (rank < cap), rank, cap), s)
    return out[:, :cap].contiguous()


def downsample_keys(keys: torch.Tensor, shape_zyx: Tuple[int, int, int],
                    cap: int, y_limit: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Active set of a stride-2 k3 p1 conv: [B, M] keys on `shape_zyx` ->
    [B, cap] ascending keys on the output grid, INVALID_KEY padded; the
    lowest keys win the cap. y_limit: optional [B] int32 exclusive bound
    on the output y of each row (the banded stage's global grid top in
    band coordinates). Keys must lie on `shape_zyx`. K7 on the card: a
    bitmap of the output grid, ranked, no sort."""
    if keys.device.type == "cpu":
        return downsample_keys_plain(keys, shape_zyx, cap, y_limit)
    cuda.check_cuda("keys", keys, torch.int32, 2)
    b, m = keys.shape
    if y_limit is not None:
        cuda.check_cuda("y_limit", y_limit, torch.int32, 1)
        if y_limit.shape[0] != b:
            raise ValueError(f"y_limit {tuple(y_limit.shape)} does not fit "
                             f"keys {tuple(keys.shape)}")
    d, h, w = shape_zyx
    od, oh, ow = out_shape_stride2(shape_zyx)
    tiles = -(-(od * oh * ow) // K7_TILE_CELLS)
    words = b * tiles * (K7_TILE_CELLS // 32)
    with torch.cuda.device(keys.device):
        # scratch: the bitmap (cleared by K7), then the per-tile counts
        work = torch.empty(words + b * tiles, dtype=torch.int32,
                           device=keys.device)
        out = torch.empty((b, cap), dtype=torch.int32, device=keys.device)
        _K7.launch(keys.data_ptr(), b, m, d, h, w, od, oh, ow,
                   None if y_limit is None else y_limit.data_ptr(), tiles,
                   work.data_ptr(), work.data_ptr() + 4 * words, cap,
                   out.data_ptr())
    return out


def device_rulebook(keys0: torch.Tensor,
                    level_shapes: Sequence[Tuple[int, int, int]],
                    level_caps: Sequence[int], train: bool = False,
                    aux: bool = True,
                    y_top: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
    """The backbone's rulebook built on the keys' device, in the host
    rulebook's format (data.kitti.build_host_plans without the plan_
    prefix): subm0..2 and stride1..3 [B, 27, capL] int32 plans, and
    coords1..3 [B, capL, 3] int32; with `train` also strideT1..3 [B, 27,
    cap_{L-1}] (K13) and, with `aux`, aux1..3 [B, 27, cap0] (K14), each
    one launch for the three levels after the last, through the index
    maps of levels 1-3 (level 3's is built for them).

    keys0: [B, cap0] key-sorted level-0 keys; level_shapes: the four level
    grids; level_caps: the caps of levels 1..3; y_top: optional [B] int32
    exclusive level-0 y bound of each row, which clips level L's
    downsample at y_top >> L (the banded stage). Level 3 gets no subm plan:
    the dense tail runs it. The level-0 map (360 MB a sample at the car
    grid) is freed once its plans are built, each later map once its
    plans are built unless `train` still needs it.
    """
    plans, maps = {}, {}
    keys, shape = keys0, level_shapes[0]
    level_keys = [keys0]
    imap = build_index_map(keys, shape)
    plans["subm0"] = window_plan(keys, shape, imap, shape, 1)
    for lvl in (1, 2, 3):
        out_shape = level_shapes[lvl]
        out = downsample_keys(keys, shape, level_caps[lvl - 1],
                              None if y_top is None else y_top >> lvl)
        plans[f"stride{lvl}"] = window_plan(out, out_shape, imap, shape, 2)
        plans[f"coords{lvl}"] = keys_to_coords(out, out_shape)
        keys, shape = out, out_shape
        level_keys.append(keys)
        imap = None
        if lvl < 3 or train:
            imap = build_index_map(keys, shape)
        if train:
            maps[lvl] = imap
        if lvl < 3:
            plans[f"subm{lvl}"] = window_plan(keys, shape, imap, shape, 1)
    if train:
        levels = [maps[lvl] for lvl in (1, 2, 3)]
        for lvl, plan in zip((1, 2, 3), stride_plans_T(
                level_keys[:3], levels, level_shapes)):
            plans[f"strideT{lvl}"] = plan
        if aux:
            cell0 = keys_to_coords(keys0, level_shapes[0])
            for lvl, plan in zip((1, 2, 3),
                                 aux_plans(cell0, levels, level_shapes[1:])):
                plans[f"aux{lvl}"] = plan
    return plans
