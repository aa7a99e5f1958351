"""The bfloat16 rounding points of a port run (model.compute_dtype=
"bfloat16"), named, recorded, and forced to another run's neighbour at
ties: the teacher forcing that lets two bfloat16 runs which sum in
different orders be held to each other at fixed tolerances.

Two such runs take the same rounding points, but wherever a value lies
within their float32 sums' difference of a bfloat16 rounding boundary
they round it to different neighbours, and train-mode BatchNorm's
backward amplifies that one-ulp step: on tiny_config() it moves the
vxnet, bevnet and PSWarp gradients by tenths of their norm. Forcing the
second run, at exactly those ties, to the first run's neighbour leaves
the two runs differing only by their float32 sums.

A point is named by its kind and the count of that kind before it in the
run ("sparse3.g": the output gradient of the run's fourth sparse conv,
before its backward rounds it):

- sparseN.x, sparseN.g: a sparse conv's input (rounded inside the conv)
  and its output gradient (rounded inside its backward);
- reluN: a ReLU's output in VxNet's dense tail (the last is the 1x1x1
  conv's input, rounded there; a sparse level's is the next conv's
  input, seen there);
- denseN.x, .y, .g, .dx, .dw: a bfloat16 dense conv (layers.conv2d_oihw):
  its input, its output, its output gradient and its input and weight
  gradients, each rounded to bfloat16;
- x1x1.dx, x1x1.dw: the 1x1x1 conv's operand gradients, rounded to
  bfloat16 (sparse.rounded's backward).

Values are kept in the JAX package's layouts (NHWC, HWIO; the tail as
[B, H, W, D, C]) so that tests/test_torch_bf16.py can set them beside the
JAX package's. `patch` installs the points with the port's own dense conv
(`twin=False`: its outputs are seen rounded, as cuDNN gives them) or with
its twin (`twin=True`): the same conv summed in float32 on the rounded
operands and rounded here, so that the value before rounding is seen and
can be forced. chip_smoke.py phase 13 records a card run with the first
and forces a CPU run with the second; tests/test_torch_bf16.py records
the port with the twin and forces the JAX package's run.
"""
import collections
import contextlib
import functools
import types

import torch
import torch.nn.functional as F

# a value is a tie when its float32 value before rounding lies within this,
# relative to the tensor's largest magnitude, of the midpoint between its
# neighbour and the other run's: two or three float32 ulps at that
# magnitude, the port's and the JAX package's float32 sums' difference on
# tiny_config() (tests/test_torch_bf16.py)
TIE_RTOL = 2e-7
BF16 = torch.bfloat16
TAIL_CHANNELS = 64          # the dense tail's channels per z slice


def rne(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16 (to nearest, ties to even), kept float32."""
    return t.to(BF16).to(torch.float32)


def ties(c: torch.Tensor, q: torch.Tensor, tol: float = TIE_RTOL,
         sums=None):
    """Where c (float32, before rounding) rounds to another bfloat16 value
    than q (the other run's rounded value) and lies within tol of the
    midpoint between the two, relative to the tensor's largest magnitude
    or, where given, to each value's sum of |products| (`sums`, a conv's
    own output): a tie that the two runs' float32 sums broke apart."""
    return tie_gap(c, q, sums) <= tol


def tie_gap(c, q, sums=None):
    """|c - the midpoint to q| over the scale of `ties`; inf where c
    rounds to q."""
    rc = rne(c)
    mid = (rc + q) * 0.5           # exact: two adjacent bfloat16 values
    if sums is None:
        sums = torch.full_like(c, float(c.abs().max()) if c.numel() else 0.0)
    gap = (c - mid).abs() / sums.clamp(min=1e-30)
    return torch.where(rc != q, gap, torch.full_like(gap, float("inf")))


class Points:
    """The rounding points of one run. `seen[name]` holds each point's
    values (float32 before rounding; a dense conv's outputs rounded where
    the port's own conv ran), in the JAX layout; with `ref` (name ->
    values of another run, same layout) every tie (`ties`) with the other
    run's rounded value is set to it before rounding (`tol`; `sum_tol`
    of the sums of |products| at a conv's own outputs, where `patch`
    gives them), `forced[name]` holds where, and `apart[name]` counts
    the values that round to another neighbour than the other run's and
    are no tie, beside the largest of their gaps (`tie_gap`). `convs`
    keeps each of the port's own dense convs' weight and padding."""

    def __init__(self, ref=None, tol: float = TIE_RTOL, sum_tol=None):
        self.ref, self.tol, self.sum_tol = ref, tol, sum_tol
        self.seen, self.forced, self.apart, self.convs = {}, {}, {}, {}
        self.count = collections.Counter()

    def name(self, kind: str) -> str:
        i = self.count[kind]
        self.count[kind] += 1
        return f"{kind}{i}"

    def at(self, name: str, t: torch.Tensor, to_jax=None,
           from_jax=None, sums=None) -> torch.Tensor:
        """Record t at the point `name` and return it with its ties set
        (straight through: the gradient passes unchanged); `sums`: t's
        sums of |products| where t is a conv's own output."""
        v = t.detach()
        self.seen[name] = (to_jax(v) if to_jax else v).float().cpu().clone()
        if self.ref is None:
            return t
        q = self.ref[name]
        q = rne((from_jax(q) if from_jax else q).to(v.device))
        if sums is None or self.sum_tol is None:
            sums, tol = None, self.tol
        else:
            tol = self.sum_tol
        gap = tie_gap(v, q, sums)
        m = gap <= tol
        self.forced[name] = (to_jax(m) if to_jax else m).cpu()
        apart = (gap > tol) & torch.isfinite(gap)
        self.apart[name] = (int(apart.sum()), float(gap[apart].max())
                            if apart.any() else 0.0)
        return t + torch.where(m, q - v, torch.zeros_like(v))


class _AtGrad(torch.autograd.Function):
    """Identity; its backward takes the incoming gradient through
    Points.at."""

    @staticmethod
    def forward(ctx, t, pts, name, to_jax, from_jax):
        ctx.args = (pts, name, to_jax, from_jax)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        pts, name, to_jax, from_jax = ctx.args
        return pts.at(name, g, to_jax, from_jax), None, None, None, None


def at_grad(t, pts, name, to_jax=None, from_jax=None):
    return _AtGrad.apply(t, pts, name, to_jax, from_jax)


def nchw_to_nhwc(t):
    return t.permute(0, 2, 3, 1)


def nhwc_to_nchw(t):
    return t.permute(0, 3, 1, 2)


def oihw_to_hwio(t):
    return t.permute(2, 3, 1, 0)


def hwio_to_oihw(t):
    return t.permute(3, 2, 0, 1)


def tail_to_jax(t):
    """The dense tail's [B, D, C, H, W] as the JAX package's [B, H, W, D,
    C] (the same permutation maps back)."""
    return t.permute(0, 3, 4, 1, 2)


class _Twin(torch.autograd.Function):
    """The bfloat16 "mixed" conv (layers.conv2d_oihw without its bias) on
    float32: the operands rounded, the products (exact) summed in float32,
    each result rounded here, so its value before rounding passes through
    Points.at: the output; in the backward the output gradient, then the
    input and weight gradients."""

    @staticmethod
    def forward(ctx, x, w, padding, pts, name):
        xr = rne(pts.at(name + ".x", x, nchw_to_nhwc, nhwc_to_nchw))
        wr = rne(w)
        y = F.conv2d(xr, wr, padding=padding)
        sums = (F.conv2d(xr.abs(), wr.abs(), padding=padding)
                if pts.sum_tol else None)
        ctx.save_for_backward(xr, wr)
        ctx.args = (padding, pts, name)
        return rne(pts.at(name + ".y", y, nchw_to_nhwc, nhwc_to_nchw,
                          sums))

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        padding, pts, name = ctx.args
        g = rne(pts.at(name + ".g", g, nchw_to_nhwc, nhwc_to_nchw))
        dx = torch.nn.grad.conv2d_input(xr.shape, wr, g, padding=padding)
        dw = torch.nn.grad.conv2d_weight(xr, wr.shape, g, padding=padding)
        sx = sw = None
        if pts.sum_tol:
            sx = torch.nn.grad.conv2d_input(xr.shape, wr.abs(), g.abs(),
                                            padding=padding)
            sw = torch.nn.grad.conv2d_weight(xr.abs(), wr.shape, g.abs(),
                                             padding=padding)
        return (rne(pts.at(name + ".dx", dx, nchw_to_nhwc, nhwc_to_nchw,
                           sx)),
                rne(pts.at(name + ".dw", dw, oihw_to_hwio, hwio_to_oihw,
                           sw)),
                None, None, None)


@contextlib.contextmanager
def patch(pts: Points, twin: bool):
    """Install the rounding points of `pts` in the port's VxNet, BEVNet,
    PSWarp and dense tail for the duration; with `twin` the bfloat16 dense
    convs run as _Twin, else as the port's own conv (cuDNN on the card),
    with their rounded outputs recorded (and their weights, `convs`)."""
    from sassd_tpu_torch.models import backbone, layers
    from sassd_tpu_torch.ops import sparse as sp
    conv = layers.conv2d_oihw

    def dense(x, w, b=None, padding=0, compute_dtype=torch.float32):
        if compute_dtype == torch.float32:
            return conv(x, w, b, padding, compute_dtype)
        name = pts.name("dense")
        if twin:
            y = _Twin.apply(x, w, padding, pts, name)
        else:
            pts.convs[name] = (w.detach(), padding)
            x = at_grad(pts.at(name + ".x", x, nchw_to_nhwc, nhwc_to_nchw),
                        pts, name + ".dx", nchw_to_nhwc, nhwc_to_nchw)
            w = at_grad(w, pts, name + ".dw", oihw_to_hwio, hwio_to_oihw)
            y = conv(x, w, None, padding, compute_dtype)
            y = at_grad(pts.at(name + ".y", y, nchw_to_nhwc, nhwc_to_nchw),
                        pts, name + ".g", nchw_to_nhwc, nhwc_to_nchw)
        return y if b is None else y + b.reshape(-1, 1, 1)

    def sparse(fn, x, *args):
        name = pts.name("sparse")
        y = fn(pts.at(name + ".x", x), *args)
        return at_grad(y, pts, name + ".g")

    def relu(x):
        y = layers.relu(x)
        if y.dim() != 5:       # a sparse level's: the next conv's input
            return y
        return pts.at(pts.name("relu"), y, tail_to_jax, tail_to_jax)

    def rounded(t, compute_dtype):
        if compute_dtype == torch.float32:
            return t
        # the 1x1x1 conv's operands: the tail's [B, D*C, H, W], then W
        name = "x1x1.dx" if t.dim() == 4 else "x1x1.dw"
        to_jax = from_jax = None
        if t.dim() == 4:
            b, dc, h, w = t.shape
            
            def to_jax(u):
                return tail_to_jax(u.reshape(b, -1, TAIL_CHANNELS, h, w))

            def from_jax(u):
                return tail_to_jax(u).reshape(b, dc, h, w)
        return at_grad(sp.rounded(t, compute_dtype), pts, name, to_jax,
                       from_jax)

    sp_points = types.SimpleNamespace(**vars(sp))
    for f in ("subm_conv_sym", "stride_conv_hostT", "subm_conv_batched"):
        setattr(sp_points, f, functools.partial(sparse, getattr(sp, f)))
    sp_points.rounded = rounded
    layers_points = types.SimpleNamespace(**vars(layers))
    layers_points.relu = relu
    layers_points.conv2d_oihw = dense
    saved = (layers.conv2d_oihw, backbone.sp, backbone.L)
    layers.conv2d_oihw, backbone.sp, backbone.L = (dense, sp_points,
                                                   layers_points)
    try:
        yield pts
    finally:
        layers.conv2d_oihw, backbone.sp, backbone.L = saved
