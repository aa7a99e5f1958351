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
- K4-bf16 and K10-bf16: the same two in ``compute_dtype=torch.bfloat16``
  (model.compute_dtype="bfloat16"): the features and the weights (or the
  output gradients) rounded to bfloat16 once a call, before the gather, as
  the JAX package's astype after it (the same bits), the products on the
  tensor cores (mma.sync) summed in float32, as its ``jnp.dot(...,
  preferred_element_type=float32)`` of bfloat16 operands;
- K5 ``densify_nchw``: the last level into the dense tail's NCHW canvas,
  and K5b its backward (``densify.cu``);
- K6 ``build_index_map`` + ``window_plans``: the device rulebook's dense
  key -> row maps and the plans resolved through them, a scan's six plans
  in one launch (``device_plans.cu``);
- K17 ``update_index_maps``: persistent-plan serving's delta update of
  maps that live across scans, the previous scan's rows cleared and this
  scan's set, the three levels in one call (``device_plans.cu``);
- K7 ``downsample_keys``: the sorted, capped active set of a stride-2
  level, optionally with a per-row output-y limit (``downsample.cu``);
- K13 ``stride_plans_T`` and K14 ``aux_plans``: the rulebook's train-only
  plans, the stride convs' transpose plans and the aux branch's ring
  plans, each of its three levels in one launch (``device_plans.cu``);
- K18 ``sorted_window_plans``, K19 ``sorted_stride_plans_T`` and K20
  ``sorted_aux_plans``: the same plans as K6's, K13's and K14's, resolved
  by binary search over each level's sorted keys with no index map
  (model.plan_lookup="sorted", ``device_plans.cu``).

Training differentiates the convs through :func:`subm_conv_sym` and
:func:`stride_conv_hostT` (autograd Functions whose forward is K4 and whose
backward is K4 for the input gradient and K10 for the weight gradient) and
the dense tail's entry through :func:`densify_nchw` (K5, K5b). On CPU
tensors each is its plain forward under ordinary autograd; in bfloat16 the
convs' Functions run there too, over the plain versions, so their
backward rounds the output gradients and the weights to bfloat16 and not
the gradients it returns, as the JAX package's custom VJPs do.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

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
# their bfloat16 entry points: K4-bf16 reads W through its strides and
# takes scratch for the rounded operands, K10-bf16 takes that scratch too
_K4B = cuda.Kernel("sassd_sparse_conv_bf16",
                   _K4.argtypes[:7] + [cuda.P] + [cuda.I] * 6
                   + [cuda.P, cuda.P])
_K10B = cuda.Kernel("sassd_sparse_conv_dw_bf16", _K10.argtypes + [cuda.P])
# K10's blocks: each multiplies an equal share of all taps' found rows and
# writes a [Cin, Cout] partial per tap it touches, which a last pass sums
# in block order (two blocks an SM of the H100's 132)
K10_BLOCKS = 264
_K6_MAP = cuda.Kernel("sassd_index_map",
                      [cuda.P, cuda.I, cuda.I, cuda.L, cuda.P])
# K17 and K6's plans take their levels' and plans' descriptors as a host
# array of int64 (cuda.descriptors)
_K17 = cuda.Kernel("sassd_index_maps_update", [cuda.P, cuda.I, cuda.I])
_K6_PLANS = cuda.Kernel("sassd_window_plans", [cuda.P, cuda.I, cuda.I])
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
# the sorted-key rulebook: K18 takes its plans' descriptors as K6's plans
# do, K19 and K20 their levels' keys, counts and grids as arguments
_K18 = cuda.Kernel("sassd_sorted_window_plans", [cuda.P, cuda.I, cuda.I])
_K19 = cuda.Kernel("sassd_sorted_stride_plans_t",
                   [cuda.P] * 6 + [cuda.I] * 19 + [cuda.P] * 3)
_K20 = cuda.Kernel("sassd_sorted_aux_plans",
                   [cuda.P, cuda.I, cuda.I] + [cuda.P] * 3 + [cuda.I] * 12
                   + [cuda.P])
# the C entry points of each kernel id, for launch counts
KERNEL_SYMBOLS = {
    "K4": ("sassd_sparse_conv",),
    "K5": ("sassd_densify",),
    "K5b": ("sassd_densify_bwd",),
    "K10": ("sassd_sparse_conv_dw",),
    "K4-bf16": ("sassd_sparse_conv_bf16",),
    "K10-bf16": ("sassd_sparse_conv_dw_bf16",),
    "K6": ("sassd_index_map", "sassd_window_plans"),
    "K17": ("sassd_index_maps_update",),
    "K7": ("sassd_downsample",),
    "K13": ("sassd_stride_plans_t",),
    "K14": ("sassd_aux_plans",),
    "K18": ("sassd_sorted_window_plans",),
    "K19": ("sassd_sorted_stride_plans_t",),
    "K20": ("sassd_sorted_aux_plans",),
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


def rounded(t: torch.Tensor, compute_dtype) -> torch.Tensor:
    """t's values rounded to compute_dtype (to nearest, ties to even) and
    kept in t's dtype: a product's operand as the card takes it in that
    type. Float32 leaves t as it is."""
    if compute_dtype == torch.float32:
        return t
    return t.to(compute_dtype).to(t.dtype)


def _is_bf16(compute_dtype) -> bool:
    """Whether a sparse conv kernel computes in bfloat16 (K4-bf16,
    K10-bf16) rather than float32 (K4, K10); any other dtype raises."""
    if compute_dtype == torch.float32:
        return False
    if compute_dtype == torch.bfloat16:
        return True
    raise TypeError(f"no sparse conv kernel computes in {compute_dtype}")


def gather_im2col(feats: torch.Tensor, plan: SubmPlan) -> torch.Tensor:
    """[M_in, C] features + [K, M] plan -> [M, K*C] im2col (missing -> 0)."""
    k, m = plan.idx.shape
    g = torch.index_select(feats, 0, plan.idx.reshape(-1)).reshape(k, m, -1)
    g = torch.where(plan.found[..., None], g, 0.0)
    return g.transpose(0, 1).reshape(m, -1)


def subm_conv(feats: torch.Tensor, weight: torch.Tensor,
              plan: SubmPlan, compute_dtype=torch.float32) -> torch.Tensor:
    """Gather-GEMM sparse conv: [M_in, Cin] x [K, Cin, Cout] -> [M, Cout],
    the operands rounded to compute_dtype, the sums in feats' dtype."""
    k, cin, cout = weight.shape
    return (gather_im2col(rounded(feats, compute_dtype), plan)
            @ rounded(weight, compute_dtype).reshape(k * cin, cout))


def subm_conv_batched_plain(feats: torch.Tensor, weight: torch.Tensor,
                            plan: torch.Tensor,
                            compute_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of K4 and K4-bf16 (see subm_conv_batched)."""
    b, m_in, c = feats.shape
    m_out = plan.shape[-1]
    out = subm_conv(feats.reshape(b * m_in, c), weight,
                    flatten_plan(host_plan(plan), m_in), compute_dtype)
    return out.reshape(b, m_out, -1)


def bf16_panel(weight: torch.Tensor, n_cols: Optional[int] = None,
               taps_reversed: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K4-bf16's weight operand, which its first
    phase writes once a call: a conv's [27, K, N] weight (any view) rounded
    to bfloat16 (JAX's ``weight.reshape(27 * K, N).astype(bfloat16)``,
    rearranged) as a [27, n_cols, Kp] panel (n_cols >= N, default N; Kp =
    K rounded up to 16; zeros past K and N), each 16 input channels in the
    order of an mma B fragment (0 1 8 9 2 3 10 11 4 5 12 13 6 7 14 15), so a
    lane's two B registers of a k step are one 8-byte load; its tap t is
    the weight's 26 - t where `taps_reversed`."""
    taps, k, n = weight.shape
    kp = -(-k // 16) * 16
    n_cols = n if n_cols is None else n_cols
    if taps_reversed:
        weight = weight.flip(0)
    weight = torch.nn.functional.pad(weight, (0, n_cols - n, 0, kp - k))
    # channel 16 s + 8 h + 2 q + p -> position 16 s + 4 q + 2 h + p
    return (weight.reshape(taps, kp // 16, 2, 4, 2, n_cols)
            .permute(0, 5, 1, 3, 2, 4)
            .to(torch.bfloat16, memory_format=torch.contiguous_format)
            .reshape(taps, n_cols, kp))


def subm_conv_batched(feats: torch.Tensor, weight: torch.Tensor,
                      plan: torch.Tensor,
                      compute_dtype=torch.float32) -> torch.Tensor:
    """Sparse conv over a batch as one flat gather-GEMM (K4 on the card;
    K4-bf16 with compute_dtype=torch.bfloat16).

    feats: [B, M_in, Cin] float32; weight: [27, Cin, Cout] float32
    (contiguous for K4; any view for K4-bf16, which reads it through its
    strides); plan: the wire-format [B, 27, M_out] int16/int32 plan (-1 =
    missing) with rows into each sample's M_in input rows (a subm plan, or
    a stride plan into the previous level). Returns [B, M_out, Cout]
    float32.
    """
    if feats.device.type == "cpu":
        return subm_conv_batched_plain(feats, weight, plan, compute_dtype)
    if _is_bf16(compute_dtype):
        return _k4_bf16(feats, weight, plan, False, weight.shape[2])
    _k4_checks(feats, weight, plan, weight.shape[2])
    b, m_in, cin = feats.shape
    m_out, cout = plan.shape[2], weight.shape[2]
    out = torch.empty((b, m_out, cout), dtype=torch.float32,
                      device=feats.device)
    _K4.launch_on(feats, feats.data_ptr(), m_in, cin, plan.data_ptr(),
                  int(plan.dtype == torch.int16), b, m_out, weight.data_ptr(),
                  cout, out.data_ptr())
    return out


def _k4_checks(feats: torch.Tensor, weight: torch.Tensor, plan: torch.Tensor,
              cout: int, dense_weight: bool = True) -> None:
    """Raise unless K4 / K4-bf16 take these inputs for `cout` output
    columns (the weight contiguous unless not `dense_weight`)."""
    cuda.check_cuda("feats", feats, torch.float32, 3)
    cuda.check_cuda("weight", weight, torch.float32, 3,
                    contiguous=dense_weight)
    if plan.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"plan must be int16 or int32, got {plan.dtype}")
    cuda.check_cuda("plan", plan, plan.dtype, 3)
    b, m_in, cin = feats.shape
    if plan.shape[:2] != (b, 27) or weight.shape[:2] != (27, cin):
        raise ValueError(f"plan {tuple(plan.shape)} / weight "
                         f"{tuple(weight.shape)} do not fit feats "
                         f"{tuple(feats.shape)}")
    if cin % 4 or cin > 64 or cout not in (16, 32, 64):
        raise ValueError(f"K4 takes Cin a multiple of 4 up to 64 and Cout "
                         f"16, 32 or 64, got {cin} -> {cout}")
    if feats.data_ptr() % 16 or (dense_weight and weight.data_ptr() % 16):
        raise ValueError("feats and weight must be 16-byte aligned "
                         "(16-byte copies)")


def _k4_bf16(feats: torch.Tensor, weight: torch.Tensor, plan: torch.Tensor,
             taps_reversed: bool, cout: int) -> torch.Tensor:
    """K4-bf16 on the card: [B, M_in, Cin] features, a [27, Cin, N] weight
    view (its tap t read from 26 - t where `taps_reversed`) and the wire
    plan -> [B, M_out, cout] float32, columns past N zero (cout >= N). One
    launch: it rounds the features and the weight once (the bfloat16 copy
    and bf16_panel's panel, into scratch), then runs the conv."""
    _k4_checks(feats, weight, plan, cout, dense_weight=False)
    b, m_in, cin = feats.shape
    m_out = plan.shape[2]
    rows16 = -(-b * m_in * cin // 8) * 8
    work = torch.empty(2 * (rows16 + 27 * cout * (-(-cin // 16) * 16)),
                       dtype=torch.uint8, device=feats.device)
    out = torch.empty((b, m_out, cout), dtype=torch.float32,
                      device=feats.device)
    st, sk, sn = weight.stride()
    _K4B.launch_on(feats, feats.data_ptr(), m_in, cin, plan.data_ptr(),
                   int(plan.dtype == torch.int16), b, m_out,
                   weight.data_ptr(), st, sk, sn, int(taps_reversed),
                   weight.shape[2], cout, work.data_ptr(), out.data_ptr())
    return out


def conv_weight_grad_plain(feats: torch.Tensor, plan: torch.Tensor,
                           d_out: torch.Tensor,
                           compute_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of K10 and K10-bf16 (see conv_weight_grad)."""
    b, m_in, cin = feats.shape
    col = gather_im2col(rounded(feats, compute_dtype).reshape(b * m_in, cin),
                        flatten_plan(host_plan(plan), m_in))
    dw = col.T @ rounded(d_out, compute_dtype).reshape(-1, d_out.shape[-1])
    return dw.reshape(27, cin, -1)


def conv_weight_grad(feats: torch.Tensor, plan: torch.Tensor,
                     d_out: torch.Tensor,
                     compute_dtype=torch.float32) -> torch.Tensor:
    """dW = im2col(feats, plan)^T . d_out of a sparse conv (K10 on the
    card, K10-bf16 with compute_dtype=torch.bfloat16: both operands
    rounded to bfloat16, float32 sums; the im2col is never built there).

    feats: [B, M_in, Cin] float32, the conv's input; plan: its wire-format
    [B, 27, M_out] plan; d_out: [B, M_out, Cout]. Returns [27, Cin, Cout].
    """
    if feats.device.type == "cpu":
        return conv_weight_grad_plain(feats, plan, d_out, compute_dtype)
    bf16 = _is_bf16(compute_dtype)
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
    # one scratch buffer: counts, totals, the (input, output) row pairs,
    # the partials and (K10-bf16) the bfloat16 copies of feats and d_out,
    # each at a 16-byte offset
    sizes = [4 * n_counts, 4 * 27, 8 * 27 * rows,
             4 * (K10_BLOCKS + 27) * cin * cout]
    if bf16:
        sizes.append(2 * (-(-b * m_in * cin // 8) * 8 + rows * cout))
    offs = [0]
    for n in sizes:
        offs.append(offs[-1] + -(-n // 16) * 16)
    work = torch.empty(offs[-1], dtype=torch.uint8, device=feats.device)
    dw = torch.empty((27, cin, cout), dtype=torch.float32,
                     device=feats.device)
    base = work.data_ptr()
    ptrs = [base + o for o in offs[:len(sizes)]]
    (_K10B if bf16 else _K10).launch_on(
        feats, feats.data_ptr(), m_in, cin, plan.data_ptr(),
        int(plan.dtype == torch.int16), b, m_out, d_out.data_ptr(), cout,
        K10_BLOCKS, *ptrs[:4], dw.data_ptr(), *ptrs[4:])
    return dw


def _subm_input_grad(d_out: torch.Tensor, weight: torch.Tensor,
                     plan: torch.Tensor,
                     compute_dtype=torch.float32) -> torch.Tensor:
    """d_feats of a submanifold conv: K4 on the same (symmetric) plan with
    the taps reversed and the weight transposed, [27, Cout, Cin]. K4
    writes 16, 32 or 64 channels; an input narrower than 16 (the point
    features under the PointNet VFE, whose parameters need this
    gradient) gets zero weight columns up to 16, and its first Cin
    output channels are kept."""
    cin = weight.shape[1]
    if d_out.device.type != "cpu" and _is_bf16(compute_dtype):
        # K4-bf16 reads the transposed view with its taps reversed
        d_feats = _k4_bf16(d_out, weight.transpose(1, 2), plan, True,
                           max(cin, 16))
    else:
        d_feats = subm_conv_batched(d_out, input_grad_weight(weight)
                                    .contiguous(), plan, compute_dtype)
    return d_feats[..., :cin] if cin < 16 else d_feats


def input_grad_weight(weight: torch.Tensor) -> torch.Tensor:
    """The [27, Cout, max(Cin, 16)] weight of a submanifold conv's input
    gradient (see _subm_input_grad): the taps reversed, each tap's [Cin,
    Cout] transposed, zero columns past a Cin under 16."""
    w_rev = weight.flip(0).transpose(1, 2)
    cin = w_rev.shape[2]
    if cin < 16:
        w_rev = torch.nn.functional.pad(w_rev, (0, 16 - cin))
    return w_rev


class _SubmConvFn(torch.autograd.Function):
    """Submanifold conv: forward K4; backward K4 for d_feats (the same
    plan, taps reversed, weights transposed: the plan is symmetric; see
    _subm_input_grad) and K10 for d_weight; each in the compute dtype."""

    @staticmethod
    def forward(ctx, feats, weight, plan, compute_dtype):
        ctx.save_for_backward(feats, weight, plan)
        ctx.compute_dtype = compute_dtype
        return subm_conv_batched(feats, weight, plan, compute_dtype)

    @staticmethod
    def backward(ctx, d_out):
        feats, weight, plan = ctx.saved_tensors
        cd = ctx.compute_dtype
        d_out = d_out.contiguous()
        d_feats = d_w = None
        if ctx.needs_input_grad[0]:
            d_feats = _subm_input_grad(d_out, weight, plan, cd)
        if ctx.needs_input_grad[1]:
            d_w = conv_weight_grad(feats, plan, d_out, cd)
        return d_feats, d_w, None, None


class _StrideConvTFn(torch.autograd.Function):
    """Stride-2 conv: forward K4 on the stride plan; backward K4 on the
    transpose plan with the transposed weights for d_feats, K10 on the
    stride plan for d_weight; each in the compute dtype."""

    @staticmethod
    def forward(ctx, feats, weight, plan, plan_t, compute_dtype):
        ctx.save_for_backward(feats, weight, plan, plan_t)
        ctx.compute_dtype = compute_dtype
        return subm_conv_batched(feats, weight, plan, compute_dtype)

    @staticmethod
    def backward(ctx, d_out):
        feats, weight, plan, plan_t = ctx.saved_tensors
        cd = ctx.compute_dtype
        d_out = d_out.contiguous()
        d_feats = d_w = None
        if ctx.needs_input_grad[0]:
            w_t = weight.transpose(1, 2)
            d_feats = subm_conv_batched(
                d_out, w_t.contiguous() if cd == torch.float32 else w_t,
                plan_t, cd)
        if ctx.needs_input_grad[1]:
            d_w = conv_weight_grad(feats, plan, d_out, cd)
        return d_feats, d_w, None, None, None


def subm_conv_sym(feats: torch.Tensor, weight: torch.Tensor,
                  plan: torch.Tensor,
                  compute_dtype=torch.float32) -> torch.Tensor:
    """Differentiable submanifold conv over a batch: [B, M, Cin] features,
    [27, Cin, Cout] weight and the level's [B, 27, M] subm plan ->
    [B, M, Cout], in compute_dtype. The plan must be symmetric (input set
    = output set)."""
    if feats.device.type == "cpu" and compute_dtype == torch.float32:
        return subm_conv_batched_plain(feats, weight, plan)
    return _SubmConvFn.apply(feats, weight, plan, compute_dtype)


def stride_conv_hostT(feats: torch.Tensor, weight: torch.Tensor,
                      plan: torch.Tensor, plan_t: torch.Tensor,
                      compute_dtype=torch.float32) -> torch.Tensor:
    """Differentiable stride-2 conv over a batch: [B, M_in, Cin] features,
    the [B, 27, M_out] stride plan into the input level and its [B, 27,
    M_in] transpose plan into the output level (the host rulebook's
    strideT) -> [B, M_out, Cout], in compute_dtype."""
    if feats.device.type == "cpu" and compute_dtype == torch.float32:
        return subm_conv_batched_plain(feats, weight, plan)
    return _StrideConvTFn.apply(feats, weight, plan, plan_t, compute_dtype)


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
    out = keys.new_empty((b, total))
    _K6_MAP.launch_on(keys, keys.data_ptr(), b, m, total, out.data_ptr())
    return out


def update_index_maps_plain(maps: Sequence[torch.Tensor],
                            prev_keys: Sequence[torch.Tensor],
                            keys: Sequence[torch.Tensor]
                            ) -> List[torch.Tensor]:
    """Plain PyTorch version of K17 (see update_index_maps), in place."""
    for index_map, prev, k in zip(maps, prev_keys, keys):
        b, total = index_map.shape
        flat = index_map.view(-1)
        base = torch.arange(b, device=k.device)[:, None] * total
        for kk, clear in ((prev, True), (k, False)):
            ok = (kk >= 0) & (kk < total)
            idx = (base + kk.to(torch.int64))[ok]
            if clear:
                flat[idx] = -1
            else:
                rows = torch.arange(kk.shape[1], dtype=torch.int32,
                                    device=kk.device).expand(b, -1)
                flat[idx] = rows[ok]
    return list(maps)


def update_index_maps(maps: Sequence[torch.Tensor],
                      prev_keys: Sequence[torch.Tensor],
                      keys: Sequence[torch.Tensor],
                      shapes: Sequence[Tuple[int, int, int]]
                      ) -> List[torch.Tensor]:
    """Delta update of up to three levels' [B, D*H*W] int32 index maps, in
    place: level l's map of `prev_keys[l]` becomes the map of `keys[l]`
    ([B, M_prev] and [B, M] unique keys on `shapes[l]`, INVALID_KEY
    padded; keys off the grid are ignored). Every valid previous key's
    cell is set to -1, then every valid key's cell to its row, so a key in
    both ends set. Returns the maps, each then equal to
    build_index_map(keys[l], shapes[l]) bit for bit. K17 on the card: one
    call for the levels, the clears of all levels before the sets; it
    writes only the cells of the key sets, where a fresh map writes the
    whole grid (360 MB a sample at the car config's level 0)."""
    n = len(maps)
    if not 1 <= n <= 3 or not len(prev_keys) == len(keys) == len(shapes) == n:
        raise ValueError(f"{n} maps, {len(prev_keys)} previous keys, "
                         f"{len(keys)} keys and {len(shapes)} grids: want "
                         f"one to three of each")
    b = maps[0].shape[0]
    for lvl, (imap, prev, k, (d, h, w)) in enumerate(
            zip(maps, prev_keys, keys, shapes)):
        if (imap.dim() != 2 or imap.shape != (b, d * h * w)
                or prev.shape[0] != b or k.shape[0] != b):
            raise ValueError(f"level {lvl}: index_map {tuple(imap.shape)}, "
                             f"prev_keys {tuple(prev.shape)} and keys "
                             f"{tuple(k.shape)} are not [{b}, {d * h * w}], "
                             f"[{b}, M_prev] and [{b}, M]")
    if maps[0].is_cpu:
        return update_index_maps_plain(maps, prev_keys, keys)
    card = maps[0].get_device()
    desc = []
    for lvl, (imap, prev, k) in enumerate(zip(maps, prev_keys, keys)):
        cuda.check_cuda(f"maps[{lvl}]", imap, torch.int32, 2)
        cuda.check_cuda(f"prev_keys[{lvl}]", prev, torch.int32, 2)
        cuda.check_cuda(f"keys[{lvl}]", k, torch.int32, 2)
        if not prev.get_device() == k.get_device() == imap.get_device() == card:
            raise ValueError("the maps and keys must be on one card")
        desc += (prev.data_ptr(), prev.shape[1], k.data_ptr(), k.shape[1],
                 imap.shape[1], imap.data_ptr())
    desc = cuda.descriptors(desc)
    _K17.launch_on(maps[0], desc.buffer_info()[0], n, b)
    return list(maps)


def update_index_map_plain(index_map: torch.Tensor, prev_keys: torch.Tensor,
                           keys: torch.Tensor) -> torch.Tensor:
    """update_index_maps_plain of one level (see update_index_map)."""
    return update_index_maps_plain([index_map], [prev_keys], [keys])[0]


def update_index_map(index_map: torch.Tensor, prev_keys: torch.Tensor,
                     keys: torch.Tensor,
                     shape_zyx: Tuple[int, int, int]) -> torch.Tensor:
    """update_index_maps of one level: the [B, D*H*W] int32 map of
    `prev_keys` updated in place to that of `keys`, and returned."""
    return update_index_maps([index_map], [prev_keys], [keys],
                             [shape_zyx])[0]


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


# the plans of a scan in the order rulebook_plans makes them
RULEBOOK_PLANS = ("subm0", "stride1", "subm1", "stride2", "subm2", "stride3")
# K6's plans share one buffer; each starts at a multiple of this many
# int32 (512 bytes, the caching allocator's alignment)
_PLAN_ALIGN = 128


def window_plans_plain(specs: Sequence[tuple]) -> List[torch.Tensor]:
    """Plain PyTorch version of K6's plans (see window_plans)."""
    return [window_plan_plain(*spec) for spec in specs]


def window_plans(specs: Sequence[tuple]) -> List[torch.Tensor]:
    """27-tap plans of output rows through input levels' maps, for up to
    six specs (out_keys, out_shape, index_map, in_shape, scale).

    out_keys: [B, M_out] keys on `out_shape`; index_map: [B, D*H*W] of the
    input level on `in_shape`. Output row m's base cell is scale * its
    coords (scale 1: submanifold plan, out_shape == in_shape; scale 2:
    stride-2 plan into the previous level). Returns each spec's
    wire-format [B, 27, M_out] int32 plan, -1 = missing or off the input
    grid. K6 on the card: one launch for all the specs (views of one
    buffer), a thread an output row of a plan.
    """
    n = len(specs)
    if not 1 <= n <= 6:
        raise ValueError(f"{n} plan specs: want one to six")
    keys0 = specs[0][0]
    if keys0.is_cpu:
        return window_plans_plain(specs)
    b, card = keys0.shape[0], keys0.get_device()
    rows = []
    for i, (out_keys, out_shape, index_map, (d, h, w), scale) in enumerate(
            specs):
        cuda.check_cuda(f"specs[{i}] out_keys", out_keys, torch.int32, 2)
        cuda.check_cuda(f"specs[{i}] index_map", index_map, torch.int32, 2)
        if out_keys.shape[0] != b or index_map.shape != (b, d * h * w):
            raise ValueError(f"specs[{i}]: out_keys {tuple(out_keys.shape)} "
                             f"and index_map {tuple(index_map.shape)} are not "
                             f"[{b}, M_out] and [{b}, {d * h * w}]")
        if not out_keys.get_device() == index_map.get_device() == card:
            raise ValueError("the plans' keys and maps must be on one card")
        rows.append((out_keys.data_ptr(), out_keys.shape[1], out_shape[1],
                     out_shape[2], scale, index_map.data_ptr(), d, h, w))
    return _launch_plans(_K6_PLANS, keys0, rows)


def _launch_plans(kernel: cuda.Kernel, keys0: torch.Tensor,
                  rows: Sequence[tuple]) -> List[torch.Tensor]:
    """K6's or K18's one launch for the plans of `rows` (each a plan's
    descriptor without its plan pointer, m_out second): their [B, 27,
    m_out] int32 plans, views of one buffer, each at a multiple of
    _PLAN_ALIGN, whose pointers end the descriptors."""
    b = keys0.shape[0]
    offsets, size = [], 0
    for row in rows:
        offsets.append(size)
        size += -(-b * 27 * row[1] // _PLAN_ALIGN) * _PLAN_ALIGN
    buf = keys0.new_empty(size)
    plans, desc = [], []
    for row, off in zip(rows, offsets):
        m = row[1]
        plans.append(buf.as_strided((b, 27, m), (27 * m, m, 1), off))
        desc += row + (plans[-1].data_ptr(),)
    desc = cuda.descriptors(desc)
    kernel.launch_on(keys0, desc.buffer_info()[0], len(rows), b)
    return plans


def window_plan(out_keys: torch.Tensor, out_shape: Tuple[int, int, int],
                index_map: torch.Tensor, in_shape: Tuple[int, int, int],
                scale: int) -> torch.Tensor:
    """window_plans of one spec: the [B, 27, M_out] int32 plan."""
    return window_plans([(out_keys, out_shape, index_map, in_shape,
                          scale)])[0]


def rulebook_specs(keys: Sequence[torch.Tensor],
                   shapes: Sequence[Tuple[int, int, int]],
                   maps: Sequence[torch.Tensor]) -> List[tuple]:
    """The window_plans specs of a scan's plans (RULEBOOK_PLANS' order):
    subm{L} of level L's keys through its map and stride{L+1} of level
    L+1's keys through level L's map, for the [B, M_L] keys of levels 0-3,
    their grids and the index maps of levels 0-2."""
    specs = []
    for lvl in range(3):
        specs += [(keys[lvl], shapes[lvl], maps[lvl], shapes[lvl], 1),
                  (keys[lvl + 1], shapes[lvl + 1], maps[lvl], shapes[lvl],
                   2)]
    return specs


def rulebook_plans(keys: Sequence[torch.Tensor],
                   shapes: Sequence[Tuple[int, int, int]],
                   maps: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A scan's window plans (see rulebook_specs) in one window_plans
    call, by name."""
    return dict(zip(RULEBOOK_PLANS,
                    window_plans(rulebook_specs(keys, shapes, maps))))


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


# ---------------------------------------------------------------------------
# the sorted-key rulebook (model.plan_lookup="sorted"): the same plans
# resolved by binary search over each level's sorted keys, no index map
# ---------------------------------------------------------------------------

def lookup_sorted3_plain(keys: torch.Tensor, start: torch.Tensor):
    """Rows of the three consecutive keys start + j, j = 0..2, in each
    sample's ascending keys, by one binary search a group (the JAX
    package's lookup_sorted3, batched): [B, M] keys (INVALID_KEY tail) and
    [B, ...] starts -> (rows [B, ..., 3] int64 clipped to the row range,
    found [B, ..., 3] bool). The keys are unique, so every present query
    lies in the three rows from the first key >= start."""
    b, m = keys.shape
    k = keys.to(torch.int64)
    s = start.reshape(b, -1).to(torch.int64)
    p = torch.searchsorted(k, s)                            # [B, N], left
    pad = torch.cat([k, torch.full((b, 2), INVALID_KEY, dtype=torch.int64,
                                   device=k.device)], 1)
    pc = torch.clamp(p, 0, m - 1)
    j = torch.arange(3, device=k.device)
    win = torch.gather(pad, 1, (pc[..., None] + j).reshape(b, -1)).reshape(
        b, -1, 3)                                           # [B, N, slot]
    vals = s[..., None] + j                                 # [B, N, tap]
    cmp = win[..., :, None] == vals[..., None, :]           # [B, N, slot, tap]
    found = cmp.any(-2) & (vals != INVALID_KEY)
    slot = cmp.to(torch.uint8).argmax(-2)
    rows = torch.clamp(pc[..., None] + slot, max=m - 1)
    shape = tuple(start.shape) + (3,)
    return rows.reshape(shape), found.reshape(shape)


def window_starts(c: torch.Tensor, in_shape: Tuple[int, int, int]):
    """The searches of a window plan: [B, M, 3] int64 zyx base cells
    (negative = padding) -> ([B, 9, M] int64 first keys of the nine tap
    groups' windows, the cell before the base's x; INVALID_KEY - 3 for a
    group off the grid, as the JAX package pads them), and the [B, 9, M,
    3] masks of the groups' taps on the grid."""
    d, h, w = in_shape
    dev = c.device
    z, y, x = (c[..., i].unsqueeze(1) for i in range(3))     # [B, 1, M]
    zq = z + torch.tensor(_DZ, device=dev)[None, :, None]    # [B, 9, M]
    yq = y + torch.tensor(_DY, device=dev)[None, :, None]
    gok = ((z >= 0) & (x >= 0) & (x < w) & (zq >= 0) & (zq < d)
           & (yq >= 0) & (yq < h))
    q = (zq * h + yq) * w + x
    ok = torch.stack([gok & (x >= 1), gok, gok & (x + 1 < w)], -1)
    return torch.where(gok, q - 1, INVALID_KEY - 3), ok


def _window_sorted_plain(c: torch.Tensor, keys: torch.Tensor,
                         in_shape: Tuple[int, int, int]) -> torch.Tensor:
    """_window_lookup_plain resolved through the input level's [B, M_in]
    sorted keys instead of its map (the JAX package's _window_plan with
    sorted_keys): one lookup_sorted3 a tap group, the per-tap x masks
    after it."""
    b, m = c.shape[:2]
    start, ok = window_starts(c, in_shape)
    rows, found = lookup_sorted3_plain(keys, start)          # [B, 9, M, 3]
    plan = torch.where(found & ok, rows, -1)
    return plan.transpose(2, 3).reshape(b, 27, m).to(torch.int32)


def sorted_window_plans_plain(specs: Sequence[tuple]) -> List[torch.Tensor]:
    """Plain PyTorch version of K18 (see sorted_window_plans)."""
    return [_window_sorted_plain(
        keys_to_coords(out_keys, out_shape).to(torch.int64) * scale,
        in_keys, in_shape)
        for out_keys, out_shape, in_keys, in_shape, scale in specs]


def _check_sorted_grid(what: str, shape: Tuple[int, int, int]) -> None:
    """The searches' key arithmetic runs in int32 (start + 2 < 2^31)."""
    if shape[0] * shape[1] * shape[2] > INVALID_KEY - 3:
        raise ValueError(f"{what} grid {tuple(shape)} has more than "
                         f"{INVALID_KEY - 3} cells")


def sorted_window_plans(specs: Sequence[tuple]) -> List[torch.Tensor]:
    """window_plans resolved by binary search: up to six specs (out_keys,
    out_shape, in_keys, in_shape, scale), where in_keys is the input
    level's [B, M_in] int32 keys, ascending and unique with an INVALID_KEY
    tail (what the voxelizers and K7 make), in place of its map. Returns
    the same wire-format [B, 27, M_out] int32 plans. K18 on the card: one
    launch for all the specs, a thread an output row of a plan, its nine
    tap groups' searches advanced together (three threads a row, a z
    plane of taps each, where the rows are fewer than the card's resident
    threads); no index map is read or made.
    """
    n = len(specs)
    if not 1 <= n <= 6:
        raise ValueError(f"{n} plan specs: want one to six")
    keys0 = specs[0][0]
    if keys0.is_cpu:
        return sorted_window_plans_plain(specs)
    b, card = keys0.shape[0], keys0.get_device()
    rows = []
    for i, (out_keys, out_shape, in_keys, (d, h, w), scale) in enumerate(
            specs):
        cuda.check_cuda(f"specs[{i}] out_keys", out_keys, torch.int32, 2)
        cuda.check_cuda(f"specs[{i}] in_keys", in_keys, torch.int32, 2)
        _check_sorted_grid(f"specs[{i}] input", (d, h, w))
        if (out_keys.shape[0] != b or in_keys.shape[0] != b
                or in_keys.shape[1] < 1):
            raise ValueError(f"specs[{i}]: out_keys {tuple(out_keys.shape)} "
                             f"and in_keys {tuple(in_keys.shape)} are not "
                             f"[{b}, M_out] and [{b}, M_in >= 1]")
        if not out_keys.get_device() == in_keys.get_device() == card:
            raise ValueError("the plans' keys must be on one card")
        rows.append((out_keys.data_ptr(), out_keys.shape[1], out_shape[1],
                     out_shape[2], scale, in_keys.data_ptr(),
                     in_keys.shape[1], d, h, w))
    return _launch_plans(_K18, keys0, rows)


def sorted_rulebook_plans(keys: Sequence[torch.Tensor],
                          shapes: Sequence[Tuple[int, int, int]]
                          ) -> Dict[str, torch.Tensor]:
    """rulebook_plans through the levels' sorted keys: a scan's six plans
    in one sorted_window_plans call, by name (the specs of rulebook_specs
    with each level's keys where it takes that level's map)."""
    return dict(zip(RULEBOOK_PLANS, sorted_window_plans(
        rulebook_specs(keys, shapes, keys[:3]))))


def stride_T_starts(keys: torch.Tensor, in_shape: Tuple[int, int, int],
                    out_shape: Tuple[int, int, int]):
    """The searches of a transpose plan: [B, M] input keys -> ([B, 9, M]
    int64 first keys of the nine tap groups' windows on the output grid,
    from x parent (x - 1) // 2 (floor division; INVALID_KEY - 3 for a
    group with no live z and y parent), the [B, 9, M] group masks, and
    the [B, 1, M] x coords and window starts)."""
    od, oh, ow = out_shape
    dev = keys.device
    c = keys_to_coords(keys, in_shape).to(torch.int64)
    z, y, x = (c[..., i].unsqueeze(1) for i in range(3))     # [B, 1, M]
    cz = z - torch.tensor(_DZ, device=dev)[None, :, None]    # [B, 9, M]
    cy = y - torch.tensor(_DY, device=dev)[None, :, None]
    gok = ((z >= 0) & (cz % 2 == 0) & (cz >= 0) & (cz // 2 < od)
           & (cy % 2 == 0) & (cy >= 0) & (cy // 2 < oh))
    s = (x - 1) // 2                                         # window start
    qstart = ((cz // 2) * oh + cy // 2) * ow + s
    return torch.where(gok, qstart, INVALID_KEY - 3), gok, x, s


def _stride_T_sorted_plain(keys: torch.Tensor, out_keys: torch.Tensor,
                           in_shape: Tuple[int, int, int],
                           out_shape: Tuple[int, int, int]) -> torch.Tensor:
    """One level of sorted_stride_plans_T_plain (the JAX package's
    build_stride_plan_T with out_sorted_keys): [B, M] input keys ->
    [B, 27, M]. A tap group's x taps read coarse cells inside its window,
    one lookup_sorted3 a group."""
    ow = out_shape[2]
    b, m = keys.shape
    start, gok, x, s = stride_T_starts(keys, in_shape, out_shape)
    rows, found = lookup_sorted3_plain(out_keys, start)      # [B, 9, M, 3]
    taps = []
    for dx in (-1, 0, 1):
        cx = x - dx
        okx = (cx % 2 == 0) & (cx >= 0) & (cx // 2 < ow)
        rel = torch.clamp(cx // 2 - s, 0, 2).expand(b, 9, m)[..., None]
        r = torch.gather(rows, 3, rel)[..., 0]
        f = torch.gather(found, 3, rel)[..., 0] & gok & okx
        taps.append(torch.where(f, r, -1))
    return torch.stack(taps, 2).reshape(b, 27, m).to(torch.int32)


def sorted_stride_plans_T_plain(keys: Sequence[torch.Tensor],
                                out_keys: Sequence[torch.Tensor],
                                shapes: Sequence[Tuple[int, int, int]]
                                ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of K19 (see sorted_stride_plans_T)."""
    return tuple(_stride_T_sorted_plain(keys[lvl], out_keys[lvl],
                                        shapes[lvl], shapes[lvl + 1])
                 for lvl in range(3))


def sorted_stride_plans_T(keys: Sequence[torch.Tensor],
                          out_keys: Sequence[torch.Tensor],
                          shapes: Sequence[Tuple[int, int, int]]
                          ) -> Tuple[torch.Tensor, ...]:
    """stride_plans_T resolved by binary search: the [B, M_L] int32 keys
    of levels 0-2, the sorted keys of levels 1-3 in place of their maps,
    and the four grids -> (strideT1, strideT2, strideT3), bit for bit
    stride_plans_T's. K19 on the card, one launch for the three levels, a
    thread an input row: only its live tap groups (at most four) are
    searched, advanced together."""
    if keys[0].device.type == "cpu":
        return sorted_stride_plans_T_plain(keys, out_keys, shapes)
    if len(keys) != 3 or len(out_keys) != 3 or len(shapes) != 4:
        raise ValueError(f"{len(keys)} keys, {len(out_keys)} output keys "
                         f"and {len(shapes)} grids: want 3, 3 and 4")
    b, card = keys[0].shape[0], keys[0].get_device()
    outs = []
    for lvl, key, okey, (d, h, w), oshape in zip(
            range(3), keys, out_keys, shapes, shapes[1:]):
        cuda.check_cuda(f"keys[{lvl}]", key, torch.int32, 2)
        cuda.check_cuda(f"out_keys[{lvl}]", okey, torch.int32, 2)
        _check_sorted_grid(f"level {lvl + 1}", oshape)
        if tuple(oshape) != out_shape_stride2((d, h, w)):
            raise ValueError(f"grid {tuple(oshape)} is not the stride-2 "
                             f"output of {(d, h, w)}")
        if key.shape[0] != b or okey.shape[0] != b or okey.shape[1] < 1:
            raise ValueError(f"keys[{lvl}] {tuple(key.shape)} and out_keys"
                             f"[{lvl}] {tuple(okey.shape)} are not [{b}, M] "
                             f"and [{b}, M_out >= 1]")
        if key.get_device() != card or okey.get_device() != card:
            raise ValueError("keys must be on one card")
        outs.append(key.new_empty((b, 27, key.shape[1])))
    _K19.launch_on(keys[0], *(k.data_ptr() for k in keys),
                   *(k.data_ptr() for k in out_keys), b,
                   *(k.shape[1] for k in keys),
                   *(k.shape[1] for k in out_keys),
                   *(s for shape in shapes for s in shape),
                   *(o.data_ptr() for o in outs))
    return tuple(outs)


def sorted_aux_plans_plain(cell0: torch.Tensor,
                           keys: Sequence[torch.Tensor],
                           shapes: Sequence[Tuple[int, int, int]]
                           ) -> torch.Tensor:
    """Plain PyTorch version of K20 (see sorted_aux_plans)."""
    c = cell0.to(torch.int64)
    return torch.stack([_window_sorted_plain(c >> lvl, k, shape)
                        for lvl, k, shape in zip((1, 2, 3), keys, shapes)])


def sorted_aux_plans(cell0: torch.Tensor, keys: Sequence[torch.Tensor],
                     shapes: Sequence[Tuple[int, int, int]]) -> torch.Tensor:
    """aux_plans resolved by binary search: [B, M0, 3] int32 level-0 zyx
    cells (-1 = padding), the sorted [B, M_L] int32 keys of levels 1-3 in
    place of their maps and their grids -> the [3, B, 27, M0] int32 plans
    aux_plans makes, bit for bit. K20 on the card, one launch for the
    three levels: K18's kernel with the three levels as its plans, a
    row of one level and sample (its base cell cell0 >> L) to a thread or
    three."""
    if cell0.device.type == "cpu":
        return sorted_aux_plans_plain(cell0, keys, shapes)
    cuda.check_cuda("cell0", cell0, torch.int32, 3)
    b, m0, k = cell0.shape
    if k != 3 or len(keys) != 3 or len(shapes) != 3:
        raise ValueError(f"cell0 {tuple(cell0.shape)} with {len(keys)} "
                         f"keys and {len(shapes)} shapes: want [B, M0, 3] "
                         f"and 3")
    for lvl, key, shape in zip((1, 2, 3), keys, shapes):
        cuda.check_cuda(f"keys[{lvl - 1}]", key, torch.int32, 2)
        _check_sorted_grid(f"level {lvl}", shape)
        if key.shape[0] != b or key.shape[1] < 1:
            raise ValueError(f"level {lvl}'s keys {tuple(key.shape)} are "
                             f"not [{b}, M >= 1]")
        if key.get_device() != cell0.get_device():
            raise ValueError("cell0 and the keys must be on one card")
    plan = cell0.new_empty((3, b, 27, m0))
    _K20.launch_on(cell0, cell0.data_ptr(), b, m0,
                   *(key.data_ptr() for key in keys),
                   *(key.shape[1] for key in keys),
                   *(s for shape in shapes for s in shape), plan.data_ptr())
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
                    y_top: Optional[torch.Tensor] = None,
                    plan_lookup: str = "dense"
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
    the dense tail runs it. K7 makes levels 1-3 first, then K6 the maps
    of levels 0-2 (and 3 with `train`) and the six plans in one call; the
    maps are freed once the plans are built (the level-0 map, 360 MB a
    sample at the car grid, with them), those of levels 1-3 after the
    train plans when `train` needs them.

    plan_lookup="sorted" (model.plan_lookup) resolves the same plans by
    binary search over each level's sorted keys and builds no index map:
    after K7, one K18 call for the six plans and, with `train`, one K19
    call for the transpose plans and, with `aux`, one K20 call. keys0
    must then be ascending within each row, as the voxelizers, K8 and the
    band partition (K16) make it; that is assumed, not checked.
    """
    if plan_lookup not in ("dense", "sorted"):
        raise ValueError(f"plan_lookup={plan_lookup!r}: want 'dense' or "
                         f"'sorted'")
    plans = {}
    level_keys = [keys0]
    for lvl in (1, 2, 3):
        level_keys.append(downsample_keys(
            level_keys[-1], level_shapes[lvl - 1], level_caps[lvl - 1],
            None if y_top is None else y_top >> lvl))
        plans[f"coords{lvl}"] = keys_to_coords(level_keys[lvl],
                                               level_shapes[lvl])
    if plan_lookup == "sorted":
        plans.update(sorted_rulebook_plans(level_keys, level_shapes))
        if train:
            for lvl, plan in zip((1, 2, 3), sorted_stride_plans_T(
                    level_keys[:3], level_keys[1:], level_shapes)):
                plans[f"strideT{lvl}"] = plan
            if aux:
                cell0 = keys_to_coords(keys0, level_shapes[0])
                for lvl, plan in zip((1, 2, 3), sorted_aux_plans(
                        cell0, level_keys[1:], level_shapes[1:])):
                    plans[f"aux{lvl}"] = plan
        return plans
    maps = [build_index_map(k, shape) for k, shape in zip(
        level_keys[:4 if train else 3], level_shapes)]
    plans.update(rulebook_plans(level_keys, level_shapes, maps))
    if train:
        levels = maps[1:]
        del maps                         # frees the level-0 map
        for lvl, plan in zip((1, 2, 3), stride_plans_T(
                level_keys[:3], levels, level_shapes)):
            plans[f"strideT{lvl}"] = plan
        if aux:
            cell0 = keys_to_coords(keys0, level_shapes[0])
            for lvl, plan in zip((1, 2, 3),
                                 aux_plans(cell0, levels, level_shapes[1:])):
                plans[f"aux{lvl}"] = plan
    return plans
