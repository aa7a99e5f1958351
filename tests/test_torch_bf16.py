"""Port parity of model.compute_dtype="bfloat16" on tiny_config(), against
the JAX package's bfloat16 path (live), through the plain versions the
CPU runs (the card's K4-bf16 and K10-bf16 are held to these in
tests/test_torch_cuda.py and chip_smoke.py):

- the sparse convs (forward, input and weight gradients): bfloat16-rounded
  operands, float32 sums (JAX: preferred_element_type=float32);
- the dense conv2d in JAX's "mixed" form (bfloat16 conv and output, then
  float32 and the bias) and the tail's 1x1x1 conv (rounded operands, a
  float32 output);
- VxNet's levels and its dense tail, forward_test on host and device
  plans, and one forward_train + backward against jax.grad;
- the banded forward against the replicated one, a .pt round trip, the
  train and test CLIs on a bfloat16 config; and the timer utilities.

Tolerances: the sparse convs' products are exact, so only the float32
sums' order differs: 1e-5 of the largest magnitude, and the result must
differ from the float32 one by more than that. conv2d within one bfloat16
ulp (2^-7 relative). Detections as tests/test_torch_detector.py (boxes
1e-2, scores 1e-3). VxNet's levels 0-2 within 1e-4 (the float32 test's),
its tail within one bfloat16 ulp; the train step's losses within 5e-3
relative and each module's gradients within 2e-2 in relative L2. These
two hold the JAX package's run with its ties forced to the port's
neighbours: wherever a value before a bfloat16 rounding lies within the
two packages' float32 sums' difference of a rounding boundary, the two
round it apart, and train-mode BatchNorm's backward amplifies that
one-ulp step to 0.24-0.34 of the vxnet, bevnet and PSWarp gradients; so
JAX's run is repeated with every such tie set to the port's neighbour
(tests/torch_bf16_points.py names and records the port's rounding points,
JaxPoints the package's, forced_jax_run forces) until no tie is left,
and every forced value is checked to be a tie (check_forced). The dense
convs there run as twins (the same conv summed in float32 and rounded
where the value before rounding can be seen), each held to its package's
own conv at one bfloat16 ulp. The port's float32 step must fail the train
step's gates. Weights are the JAX initialisation with every conv weight
scaled by sqrt(6) (weights.RELU_GAIN).
"""
import collections
import contextlib
import dataclasses
import functools
import os
import subprocess
import sys
import types
from contextlib import nullcontext

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import sassd_tpu.config as jconfig  # noqa: E402
from sassd_tpu.data.synthetic import make_random_batch as jax_random_batch  # noqa: E402
from sassd_tpu.models import backbone as jbackbone  # noqa: E402
from sassd_tpu.models import detector as jdetector  # noqa: E402
from sassd_tpu.models import layers as jlayers  # noqa: E402
from sassd_tpu.ops import sparse as jsp  # noqa: E402
from sassd_tpu_torch import config, inference, weights  # noqa: E402
from sassd_tpu_torch.data import kitti, synthetic  # noqa: E402
from sassd_tpu_torch.models import layers  # noqa: E402
from sassd_tpu_torch.models.backbone import vfe_mean  # noqa: E402
from sassd_tpu_torch.models.detector import Detector, parse_losses  # noqa: E402
from sassd_tpu_torch.ops import sparse as sp  # noqa: E402
from sassd_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from sassd_tpu_torch.utils import timer  # noqa: E402
import torch_bf16_points as bp  # noqa: E402
from test_torch_detector import matched  # noqa: E402
from test_torch_train import jax_weights, leaves  # noqa: E402
from test_torch_train_ops import jplan, t  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = torch.bfloat16
SPARSE_RTOL = 1e-5
LEVEL_ATOL = 1e-4
ULP = 2.0 ** -7
LOSS_RTOL = 5e-3
GRAD_RTOL = 2e-2
MODULES = ("vxnet", "bevnet", "head", "pswarp", "aux")


def bf16(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="bfloat16"))


def err(got, ref):
    """max |got - ref| over max |ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.fixture(scope="module")
def train_batch():
    cfg = config.tiny_config()
    batch = synthetic.make_random_batch(cfg, np.random.default_rng(2),
                                        batch_size=2, n_points=900)
    caps = (cfg.voxel.max_voxels,) + tuple(cfg.caps.level_caps[1:])
    return batch, caps


@pytest.mark.parametrize("strategy,spatial", [("data", 1), ("spatial", 2),
                                              ("banded", 2)])
def test_check_supported_takes_bfloat16(strategy, spatial):
    """compute_dtype "bfloat16" serves and trains on every strategy the
    port runs; a dtype the JAX package lacks is refused."""
    cfg = bf16(config.tiny_config())
    cfg = dataclasses.replace(cfg, parallel=config.ParallelConfig(
        strategy=strategy, spatial=spatial))
    for train in (False, True):
        config.check_supported(cfg, train=train)
    assert config.compute_dtype(cfg) == BF16
    half = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="float16"))
    with pytest.raises(NotImplementedError, match="float16"):
        config.check_supported(half)


@pytest.mark.parametrize("kind,level,cin,cout", [
    ("subm", 0, 4, 16), ("subm", 0, 16, 16), ("subm", 1, 32, 32),
    ("subm", 2, 64, 64), ("stride", 1, 16, 32), ("stride", 2, 32, 64),
    ("stride", 3, 64, 64)])
def test_sparse_conv_bf16_matches_jax(train_batch, kind, level, cin, cout):
    """Values, input and weight gradients of a bfloat16 conv (the plain
    versions of K4-bf16 and K10-bf16 under the conv Functions) against
    jax.vjp of JAX's conv with compute_dtype=bfloat16: subm through the
    symmetric custom VJP, stride through stride_conv_hostT."""
    batch, caps = train_batch
    rng = np.random.default_rng(level + cin + (10 if kind == "stride" else 0))
    plan = batch[f"plan_{kind}{level}"]
    m_in = caps[level] if kind == "subm" else caps[level - 1]
    x = rng.normal(size=(2, m_in, cin)).astype(np.float32)
    w = (rng.normal(size=(27, cin, cout)) / np.sqrt(27 * cin)).astype(
        np.float32)
    cot = rng.normal(size=(2, plan.shape[2], cout)).astype(np.float32)
    if kind == "subm":
        def jfn(xx, ww, cd=jnp.bfloat16):
            return jsp.subm_conv_batched(xx, ww, jplan(plan), cd,
                                         symmetric=True, triple=True)

        def fn(xx, ww):
            return sp.subm_conv_sym(xx, ww, t(plan), BF16)
    else:
        plan_t = batch[f"plan_strideT{level}"]

        def jfn(xx, ww, cd=jnp.bfloat16):
            return jsp.stride_conv_hostT_batched(
                cd, True, False, xx, ww, jplan(plan), jplan(plan_t))

        def fn(xx, ww):
            return sp.stride_conv_hostT(xx, ww, t(plan), t(plan_t), BF16)
    ref, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(cot))
    ref32, vjp32 = jax.vjp(lambda a, b: jfn(a, b, jnp.float32),
                           jnp.asarray(x), jnp.asarray(w))
    jdx32, jdw32 = vjp32(jnp.asarray(cot))
    xt, wt = t(x, True), t(w, True)
    out = fn(xt, wt)
    out.backward(t(cot))
    for got, want, f32 in ((out.detach(), ref, ref32), (xt.grad, jdx, jdx32),
                           (wt.grad, jdw, jdw32),
                           (sp.conv_weight_grad_plain(t(x), t(plan), t(cot),
                                                      BF16), jdw, jdw32)):
        assert err(got, want) <= SPARSE_RTOL
        # the bfloat16 rounding shows: float32 lies farther than that
        assert err(f32, want) > 10 * SPARSE_RTOL


@pytest.mark.parametrize("ksize,cin,cout,bias", [(3, 24, 16, False),
                                                 (3, 16, 28, True),
                                                 (1, 28, 28, False)])
def test_conv2d_mixed_matches_jax(ksize, cin, cout, bias):
    """layers.conv2d in bfloat16 against JAX's L.conv2d(compute_dtype=
    bfloat16): within one bfloat16 ulp elementwise, and 99.9% of the
    elements equal."""
    rng = np.random.default_rng(ksize * cin + cout)
    x = rng.normal(size=(2, 12, 10, cin)).astype(np.float32)
    w = (rng.normal(size=(ksize, ksize, cin, cout))
         / np.sqrt(ksize * ksize * cin)).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32) if bias else None
    p = {"w": jnp.asarray(w)}
    if bias:
        p["b"] = jnp.asarray(b)
    ref = np.asarray(jlayers.conv2d(p, jnp.asarray(x),
                                    compute_dtype=jnp.bfloat16))
    ref32 = np.asarray(jlayers.conv2d(p, jnp.asarray(x)))
    got = layers.conv2d(t(x), t(w), None if b is None else t(b),
                        compute_dtype=BF16).numpy()
    assert np.all(np.abs(got - ref) <= ULP * np.abs(ref) + 1e-6)
    # the same rounding point: all but the float32 sums' rare last-bit
    # flips are equal (an unrounded output would be equal almost nowhere)
    assert np.mean(got == ref) >= 0.999
    assert err(ref32, ref) > 1e-4


def test_conv2d_mixed_grads_match_jax():
    """The input and weight gradients of the bfloat16 conv2d against
    jax.vjp of JAX's: both come out of a bfloat16 conv (rounded there)
    and back to float32, so each is within one bfloat16 ulp of JAX's and
    99% of the elements are equal; the bias gradient (a float32 sum)
    within 1e-5."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 12, 10, 24)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 24, 16)) / np.sqrt(216)).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    cot = rng.normal(size=(2, 12, 10, 16)).astype(np.float32)
    _, vjp = jax.vjp(lambda xx, ww, bb: jlayers.conv2d(
        {"w": ww, "b": bb}, xx, compute_dtype=jnp.bfloat16),
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    refs = [np.asarray(g) for g in vjp(jnp.asarray(cot))]
    xt, wt, bt = t(x, True), t(w, True), t(b, True)
    layers.conv2d(xt, wt, bt, compute_dtype=BF16).backward(t(cot))
    for got, ref in ((xt.grad.numpy(), refs[0]), (wt.grad.numpy(), refs[1])):
        assert np.all(np.abs(got - ref) <= ULP * np.abs(ref) + 1e-6)
        assert np.mean(got == ref) >= 0.99
    assert err(bt.grad.numpy(), refs[2]) <= SPARSE_RTOL


def test_extra_1x1_matches_jax():
    """The tail's 1x1x1 conv in bfloat16: rounded operands into a float32
    output (no output rounding), as JAX's jnp.dot(bf16, bf16,
    preferred_element_type=float32): 1e-5."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 9, 11, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 64)) / 8).astype(np.float32)
    ref = np.asarray(jnp.dot(jnp.asarray(x).astype(jnp.bfloat16),
                             jnp.asarray(w).astype(jnp.bfloat16),
                             preferred_element_type=jnp.float32))
    xin = t(x).permute(0, 1, 4, 2, 3).reshape(10, 64, 9, 11)
    got = layers.conv2d_nchw(sp.rounded(xin, BF16),
                             sp.rounded(t(w), BF16)[None, None])
    got = got.reshape(2, 5, 64, 9, 11).permute(0, 1, 3, 4, 2).numpy()
    assert err(got, ref) <= SPARSE_RTOL
    assert err(x @ w, ref) > 1e-4


# ------------------------------------------- the JAX package's rounding points
class JaxPoints:
    """The JAX package's side of tests/torch_bf16_points.py: the same
    rounding points, named in the same order, in a jitted run. Each point
    is a host call (jax.pure_callback, opaque to XLA, so the values it
    records are the ones rounded after it) that records the point's
    float32 values before rounding in `seen` and returns them with the
    values that `force` (name -> (mask, value)) masks set."""

    def __init__(self):
        self.seen, self.force = {}, {}
        self.count = collections.Counter()

    def start(self):
        """At the start of a traced run: the counts at 0."""
        self.count.clear()

    def name(self, kind: str) -> str:
        i = self.count[kind]
        self.count[kind] += 1
        return f"{kind}{i}"

    def _host(self, name, x):
        x = np.array(x, np.float32)
        self.seen[name] = x.copy()
        if name in self.force:
            mask, value = self.force[name]
            x = np.where(mask, value, x)
        return x

    def at(self, name, x):
        """x through the point `name` (the gradient passes unchanged)."""
        host = functools.partial(self._host, name)

        @jax.custom_vjp
        def point(v):
            return jax.pure_callback(host, jax.ShapeDtypeStruct(
                v.shape, jnp.float32), v)
        point.defvjp(lambda v: (point(v), None), lambda _, g: (g,))
        return point(x)

    def at_grad(self, name):
        """Identity; its backward takes the incoming gradient through
        `at`."""
        @jax.custom_vjp
        def ident(y):
            return y

        def bwd(_, g):
            return (self.at(name, g),)
        ident.defvjp(lambda y: (y, None), bwd)
        return ident


def _jrne(x):
    return x.astype(jnp.bfloat16).astype(jnp.float32)


def _jconv(x, w, stride):
    return jax.lax.conv_general_dilated(
        x, w, (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)


def jax_twin(pts, name, stride):
    """JAX's L.conv2d(compute_dtype=bfloat16) without its bias as
    torch_bf16_points._Twin: rounded operands, float32 sums, each result
    rounded after its point (output; output, input and weight
    gradients)."""
    @jax.custom_vjp
    def conv(x, w):
        return fwd(x, w)[0]

    def fwd(x, w):
        xr, wr = _jrne(pts.at(name + ".x", x)), _jrne(w)
        return _jrne(pts.at(name + ".y", _jconv(xr, wr, stride))), (
            xr, wr)

    def bwd(res, g):
        xr, wr = res
        g = _jrne(pts.at(name + ".g", g))
        dx, dw = jax.vjp(lambda a, b: _jconv(a, b, stride), xr, wr)[1](g)
        return (_jrne(pts.at(name + ".dx", dx)),
                _jrne(pts.at(name + ".dw", dw)))
    conv.defvjp(fwd, bwd)
    return conv


def jax_dot_twin(pts):
    """The tail's jnp.dot(bf16, bf16, preferred_element_type=float32)
    with the points of its operand gradients (each a float32 product of
    the other operand by the output gradient, rounded to bfloat16)."""
    hi = jax.lax.Precision.HIGHEST

    @jax.custom_vjp
    def dot(a, b):
        return jnp.dot(a.astype(jnp.float32), b.astype(jnp.float32),
                       precision=hi)

    def bwd(res, g):
        a, b = res
        da = jnp.dot(g, b.T, precision=hi)
        db = jnp.einsum("...i,...j->ij", a, g, precision=hi)
        return (pts.at("x1x1.dx", da).astype(jnp.bfloat16),
                pts.at("x1x1.dw", db).astype(jnp.bfloat16))
    dot.defvjp(lambda a, b: (dot(a, b), (a.astype(jnp.float32),
                                         b.astype(jnp.float32))), bwd)
    return dot


@contextlib.contextmanager
def jax_points(pts: JaxPoints):
    """Install `pts` in the JAX package's VxNet, BEVNet and PSWarp for the
    duration (its bfloat16 dense convs and the tail's 1x1x1 dot as their
    twins; no file of the package changes)."""
    conv = jlayers.conv2d

    def conv2d(p, x, stride=1, compute_dtype=None):
        if compute_dtype is None or compute_dtype == jnp.float32:
            return conv(p, x, stride, compute_dtype)
        y = jax_twin(pts, pts.name("dense"), stride)(x, p["w"])
        return y + p["b"] if "b" in p else y

    def sparse(fn, xi, *args, **kw):
        name = pts.name("sparse")
        args = list(args)
        args[xi] = pts.at(name + ".x", args[xi])
        return pts.at_grad(name + ".g")(fn(*args, **kw))

    def relu(x):
        y = jlayers.relu(x)
        return pts.at(pts.name("relu"), y) if y.ndim == 5 else y

    def dot(a, b, preferred_element_type=None, **kw):
        if a.dtype != jnp.bfloat16:
            return jnp.dot(a, b, preferred_element_type=preferred_element_type,
                           **kw)
        assert preferred_element_type == jnp.float32 and not kw
        return jax_dot_twin(pts)(a, b)

    def uncovered(*args, **kw):
        raise AssertionError("a sparse conv that the points do not cover")

    sp_points = types.SimpleNamespace(**vars(jsp))
    sp_points.subm_conv_batched = functools.partial(
        sparse, jsp.subm_conv_batched, 0)
    sp_points.stride_conv_hostT_batched = functools.partial(
        sparse, jsp.stride_conv_hostT_batched, 3)
    sp_points.subm_conv = sp_points.stride_conv_hostT = uncovered
    layers_points = types.SimpleNamespace(**vars(jlayers))
    layers_points.relu, layers_points.conv2d = relu, conv2d
    jnp_points = types.SimpleNamespace(
        **{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    jnp_points.dot = dot
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers, "conv2d", conv2d)
        mp.setattr(jbackbone, "sp", sp_points)
        mp.setattr(jbackbone, "L", layers_points)
        mp.setattr(jbackbone, "jnp", jnp_points)
        yield pts


def forced_jax_run(fn, pts: JaxPoints, port_seen: dict, max_runs=40):
    """Runs `fn()` (jitted, over `pts`) until no tie is left: each run
    forces, besides the earlier ones, every value where JAX rounds to the
    other neighbour than the port with its float32 value within TIE_RTOL
    of the midpoint (torch_bf16_points.ties) to the port's neighbour.
    Returns (the last run's result, JAX's values at its points, the
    forced masks, the first (unforced) run's result)."""
    q = {k: bp.rne(v) for k, v in port_seen.items()}
    masks = {k: torch.zeros(v.shape, dtype=torch.bool) for k, v in q.items()}
    first = None
    for _ in range(max_runs):
        pts.seen = {}
        pts.force = {k: (masks[k].numpy(), q[k].numpy()) for k in q
                     if masks[k].any()}
        out = jax.block_until_ready(fn())
        first = out if first is None else first
        seen = {k: torch.from_numpy(v) for k, v in pts.seen.items()}
        assert seen.keys() == q.keys(), seen.keys() ^ q.keys()
        new = 0
        for k, v in seen.items():
            assert v.shape == q[k].shape, (k, v.shape, q[k].shape)
            tie = bp.ties(v, q[k]) & ~masks[k]
            masks[k] |= tie
            new += int(tie.sum())
        if not new:
            return out, seen, masks, first
    raise AssertionError(f"ties still new after {max_runs} runs")


def check_forced(port_seen: dict, jax_seen: dict, masks: dict):
    """Every forced value a tie: the two packages' float32 values there
    within 2 TIE_RTOL (of the tensor's largest magnitude) of each other
    (both within TIE_RTOL of the midpoint they round apart from), or
    JAX's already the port's neighbour (set at an earlier point of the
    same tensor: the tail's ReLU outputs are the next conv's input).
    Returns (forced, values at the points)."""
    forced = total = 0
    for k, m in masks.items():
        p, j = port_seen[k][m].double(), jax_seen[k][m].double()
        tie = (p - j).abs() <= 2 * bp.TIE_RTOL * port_seen[k].abs().max()
        assert bool((tie | (j == bp.rne(port_seen[k][m]))).all()), k
        forced += int(m.sum())
        total += m.numel()
    return forced, total


@pytest.mark.parametrize("package", ["port", "jax"])
def test_conv_twins_match_their_packages(package):
    """The twins that the forced comparisons below run in place of each
    package's bfloat16 dense conv (torch_bf16_points._Twin, jax_twin)
    against that package's own conv2d (for JAX also the tail's 1x1x1 dot
    against jnp.dot, jax_dot_twin): outputs and gradients within one
    bfloat16 ulp elementwise."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 12, 10, 24)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 24, 16)) / np.sqrt(216)).astype(np.float32)
    cot = rng.normal(size=(2, 12, 10, 16)).astype(np.float32)
    if package == "port":
        def conv(twin):
            xt, wt = t(x, True), t(w, True)
            with bp.patch(bp.Points(), twin=True) if twin else nullcontext():
                y = layers.conv2d(xt, wt, compute_dtype=BF16)
            y.backward(t(cot))
            return [v.detach().numpy() for v in (y, xt.grad, wt.grad)]
        pairs = [conv(True), conv(False)]
    else:
        def run(conv, dot):
            pts.start()
            y, vjp = jax.vjp(lambda xx, ww: conv(
                {"w": ww}, xx, compute_dtype=jnp.bfloat16), x, w)
            z, dvjp = jax.vjp(lambda a, b: dot(
                a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                preferred_element_type=jnp.float32), x[..., :16], w[0, 0, :16])
            return [np.asarray(v) for v in (y, *vjp(cot), z, *dvjp(cot))]
        pts, own = JaxPoints(), jlayers.conv2d
        with jax_points(pts):
            twin = run(jlayers.conv2d, jbackbone.jnp.dot)
        pairs = [twin, run(own, jnp.dot)]
    for got, ref in zip(*pairs):
        assert got.shape == ref.shape
        assert np.all(np.abs(got - ref) <= ULP * np.abs(ref) + 1e-6)


def test_vxnet_bf16_matches_jax():
    """Eval-mode VxNet in bfloat16 on host plans against JAX's vxnet_apply
    in bfloat16 with its ties forced to the port's neighbours
    (forced_jax_run): the level-0 block's output, level 1 (the aux
    branch's first middle) and level 2 within 1e-4, the dense tail's
    output within one bfloat16 ulp elementwise. Unforced, a level-1
    value that lies within the float32 sums' last bits of a rounding
    boundary rounds apart, and level 2 differs past 1e-4 downstream of
    it. Each conv alone is held at 1e-5 above."""
    cfg, jcfg = bf16(config.tiny_config()), bf16(jconfig.tiny_config())
    params, state = jax_weights()
    rng = np.random.default_rng(11)
    state = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.normal(0, 0.1, v.shape).astype(np.float32)
                      if p[-1].key == "mean" else
                      rng.uniform(0.5, 1.5, v.shape).astype(np.float32)),
        state)
    batch = synthetic.make_random_batch(cfg, np.random.default_rng(3),
                                        batch_size=2, n_points=900)
    plans = {k[5:]: v for k, v in batch.items() if k.startswith("plan_")}
    jplans = {k: jnp.asarray(v) for k, v in plans.items()}
    vfe = np.asarray(jbackbone.vfe_mean(jnp.asarray(batch["voxels"]),
                                        jnp.asarray(batch["num_points"])))
    keys = np.stack([np.asarray(jsp.coords_to_keys(
        jnp.asarray(c), cfg.sparse_shape)) for c in batch["coords"]])
    ref_l0, _ = jbackbone._subm_block(
        params["vxnet"]["conv0"], state["vxnet"]["conv0"], jnp.asarray(vfe),
        jbackbone._host_plan(jplans["subm0"]), None, False, jnp.bfloat16,
        triple=True)

    model = weights.from_jax(cfg, params, state, "cpu")
    feats = vfe_mean(torch.from_numpy(batch["voxels"]),
                     torch.from_numpy(batch["num_points"]))
    tplans = {k: torch.from_numpy(v) for k, v in plans.items()}
    with torch.no_grad():
        l0 = model.vxnet.conv0(feats, tplans["subm0"], None)
        with bp.patch(bp.Points(), twin=True) as pts:
            tail, mids = model.vxnet.forward_train(
                feats, torch.from_numpy(keys), tplans)

    jpts = JaxPoints()

    def run(p):
        jpts.start()
        out = jbackbone.vxnet_apply(
            p, state["vxnet"], jnp.asarray(keys), jnp.asarray(vfe),
            sparse_shape=jcfg.sparse_shape, level_caps=jcfg.caps.level_caps,
            train=False, compute_dtype=jnp.bfloat16, host_plans=jplans,
            dense_tail=True, store_im2col=False)
        return out[1], out[3][0][1], out[3][1][1]
    with jax_points(jpts):
        step = jax.jit(run)
        (ref_tail, mid0, mid1), seen, masks, _ = forced_jax_run(
            lambda: step(params["vxnet"]), jpts, pts.seen)
    check_forced(pts.seen, seen, masks)
    for got, ref in ((l0, ref_l0), (mids[0].feats, mid0),
                     (mids[1].feats, mid1)):
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0.1
        np.testing.assert_allclose(got.numpy(), ref, atol=LEVEL_ATOL)
    ref = np.asarray(ref_tail)
    assert np.abs(ref).max() > 0.1
    assert np.all(np.abs(tail.numpy() - ref) <= ULP * np.abs(ref) + 1e-6)


@pytest.mark.parametrize("host_plans", [True, False])
def test_forward_test_bf16_matches_live_jax(host_plans):
    """forward_test in bfloat16 against a live JAX forward_test in
    bfloat16, on host and on device plans: detections as sets."""
    cfg, jcfg = bf16(config.tiny_config()), bf16(jconfig.tiny_config())
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, host_plans=host_plans))
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, host_plans=host_plans))
    params, state = jax_weights()
    batch = synthetic.make_random_batch(cfg, np.random.default_rng(5),
                                        batch_size=2, n_points=900)
    jbatch = jax_random_batch(jcfg, np.random.default_rng(5), batch_size=2,
                              n_points=900)
    anchors = kitti.build_anchors(cfg)[0]
    ref = jdetector.forward_test(params, state,
                                 {k: jnp.asarray(v) for k, v in jbatch.items()},
                                 jnp.asarray(anchors), jcfg)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    model = weights.from_jax(cfg, params, state, "cpu")
    got = inference.make_test_step(cfg, anchors, "cpu")(model, batch)
    got = {k: v.numpy() for k, v in got.items()}
    counts = [matched(got, ref, i) for i in range(2)]
    assert min(counts) >= 3
    np.testing.assert_array_equal(got["guided_truncated"],
                                  ref["guided_truncated"])


@pytest.fixture(scope="module")
def bf16_step():
    """One forward_train + backward in bfloat16 in both packages on the
    same batch and weights: the port's, its points recorded
    (tests/torch_bf16_points.py, the dense convs as their twins), and
    jax.grad of JAX's forward_train + parse_losses (jitted) with its ties
    forced to the port's neighbours (forced_jax_run); beside them the
    port's float32 step and JAX's unforced bfloat16 step."""
    cfg, jcfg = bf16(config.tiny_config()), bf16(jconfig.tiny_config())
    params, state = jax_weights()
    batch = synthetic.make_random_batch(cfg, np.random.default_rng(5),
                                        batch_size=2, n_points=900)
    jbatch = {k: jnp.asarray(v) for k, v in jax_random_batch(
        jcfg, np.random.default_rng(5), batch_size=2, n_points=900).items()}
    anchors = kitti.build_anchors(cfg)[0]
    out, pts = {}, bp.Points()
    for name, c in (("bf16", cfg), ("f32", config.tiny_config())):
        with bp.patch(pts, twin=True) if name == "bf16" else nullcontext():
            model = weights.from_jax(c, params, state, "cpu")
            model.train()
            losses = model.forward_train(inference.to_device(batch, "cpu"),
                                         torch.from_numpy(anchors))
            parse_losses(losses).backward()
        out[name] = ({k: float(v.detach()) for k, v in losses.items()},
                     leaves(weights.grads_to_jax(model)))

    jpts = JaxPoints()

    def loss_fn(p):
        jpts.start()
        losses, _ = jdetector.forward_train(p, state, jbatch,
                                            jnp.asarray(anchors), jcfg)
        return jdetector.parse_losses(losses)[0], losses

    def result(grads_losses):
        grads, losses = grads_losses
        return ({k: float(v) for k, v in losses.items() if "loss" in k},
                leaves(grads))
    with jax_points(jpts):
        step = jax.jit(jax.grad(loss_fn, has_aux=True))
        last, seen, masks, first = forced_jax_run(
            lambda: step(params), jpts, pts.seen)
    out["jax"], out["jax_unforced"] = result(last), result(first)
    out["forced"] = check_forced(pts.seen, seen, masks)
    return out


def module_err(got, ref, module):
    """Relative L2 distance of a module's gradients (all its leaves)."""
    keys = [k for k in ref if k.startswith(f"['{module}']")]
    assert keys and set(keys) <= set(got)
    num = sum(np.sum((got[k] - ref[k]).astype(np.float64) ** 2)
              for k in keys)
    den = sum(np.sum(ref[k].astype(np.float64) ** 2) for k in keys)
    assert den > 0, module
    return float(np.sqrt(num / den))


def grad_norm(g):
    return float(np.sqrt(sum(np.sum(v.astype(np.float64) ** 2)
                             for v in g.values())))


def test_forward_train_bf16_losses_match_jax(bf16_step):
    """Every loss of the bfloat16 step within LOSS_RTOL of JAX's (ties
    forced), and the global gradient norm within GRAD_RTOL."""
    ref, got = bf16_step["jax"][0], bf16_step["bf16"][0]
    assert set(ref) <= set(got)
    for k, v in ref.items():
        assert np.isfinite(v) and v != 0.0, k
        assert abs(got[k] - v) <= LOSS_RTOL * abs(v), (k, got[k], v)
    norm, ref_norm = grad_norm(bf16_step["bf16"][1]), grad_norm(
        bf16_step["jax"][1])
    assert abs(norm - ref_norm) <= GRAD_RTOL * ref_norm


@pytest.mark.parametrize("module", MODULES)
def test_forward_train_bf16_grads_match_jax(bf16_step, module):
    """Each module's gradients within GRAD_RTOL (relative L2) of JAX's
    bfloat16 step with its ties forced to the port's neighbours."""
    err = module_err(bf16_step["bf16"][1], bf16_step["jax"][1], module)
    assert err <= GRAD_RTOL, err


def test_forward_train_bf16_gates_tell_the_dtypes_apart(bf16_step):
    """The gates above fail the port's float32 step (the rounding points
    are what they hold): its vxnet, bevnet and PSWarp gradients lie
    farther than GRAD_RTOL from JAX's bfloat16 step. Prints how many
    values the forcing set (each a tie, check_forced) and how far JAX's
    unforced bfloat16 step lies from the port's."""
    ref = bf16_step["jax"][1]
    for module in ("vxnet", "bevnet", "pswarp"):
        assert module_err(bf16_step["f32"][1], ref, module) > GRAD_RTOL
    forced, total = bf16_step["forced"]
    assert 0 < forced < total
    unforced = bf16_step["jax_unforced"][1]
    print(f"forced {forced} of {total} values; unforced JAX step from "
          f"the port: " + ", ".join(
              f"{m} {module_err(bf16_step['bf16'][1], unforced, m):.3g}"
              for m in MODULES))


def test_banded_bf16_matches_replicated():
    """forward_test in bfloat16 on test_spatial's tall tiny config: banded
    over S = 2 bands against replicated, detections as sets."""
    from test_torch_banded import tall, tall_batch
    from test_torch_train_device_plans import jax_weights as weights_for
    from test_spatial import _tall_config
    params, state = weights_for(_tall_config())
    anchors = kitti.build_anchors(tall())[0]
    dets = {}
    for name, cfg in (("banded", bf16(tall())),
                      ("replicated", bf16(tall(banded=False)))):
        model = weights.from_jax(cfg, params, state, "cpu")
        got = inference.make_test_step(cfg, anchors, "cpu")(model,
                                                            tall_batch(5))
        dets[name] = {k: v.numpy() for k, v in got.items()}
    counts = [matched(dets["banded"], dets["replicated"], i)
              for i in range(2)]
    assert min(counts) >= 3


def test_bf16_cli_train_test_and_checkpoint(tmp_path):
    """tools.train and tools.test on a bfloat16 tiny config, on the CPU:
    one epoch on the synthetic split (exit 0), a .pt whose parameters and
    optimizer moments are finite float32 and restore bitwise into a
    bfloat16 Detector, and the AP table from tools.test."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    work = tmp_path / "work"
    cfg_file = tmp_path / "bf16.py"
    cfg_file.write_text(
        "import dataclasses\n"
        "from sassd_tpu.config import tiny_config\n"
        "_c = tiny_config()\n"
        "config = dataclasses.replace(\n"
        "    _c, model=dataclasses.replace(_c.model,\n"
        "                                  compute_dtype='bfloat16'),\n"
        "    data=dataclasses.replace(\n"
        f"        _c.data, num_workers=0,\n"
        f"        root={str(work / 'synthetic_kitti')!r}),\n"
        f"    work_dir={str(work)!r})\n")

    def run(*args):
        return subprocess.run([sys.executable, "-m", *args], cwd=REPO,
                              env=env, capture_output=True, text=True,
                              timeout=300)
    res = run("sassd_tpu_torch.tools.train", str(cfg_file), "--device",
              "cpu", "--synthetic", "--epochs", "1")
    assert res.returncode == 0, res.stderr[-3000:]
    path = ckpt.latest_checkpoint(str(work))
    saved = torch.load(path)
    assert saved["step"] == 8
    for name, v in saved["model"].items():
        assert not v.is_floating_point() or (
            v.dtype == torch.float32 and torch.isfinite(v).all()), name
    for v in saved["optimizer"]["mu"].values():
        assert v.dtype == torch.float32 and torch.isfinite(v).all()
    cfg = config.load_config(str(cfg_file))
    assert cfg.model.compute_dtype == "bfloat16"
    model = Detector(cfg)
    ckpt.restore(path, model)
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k
    assert model.bevnet.conv0.compute_dtype == BF16
    res = run("sassd_tpu_torch.tools.test", str(cfg_file), path, "--device",
              "cpu", "--out", str(tmp_path / "results"))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "Car AP@0.70, 0.70, 0.70" in res.stdout


def test_timer_utilities(tmp_path, capsys):
    """TimeCatcher times a region (and prints it), trace writes a Chrome
    trace of the region's operators, timeit returns a median; on the CPU
    (device="cpu") nothing synchronises a card."""
    x = torch.ones(64, 64)
    with timer.TimeCatcher("matmul", device="cpu") as tc:
        y = x @ x
    assert tc.elapsed > 0 and "[matmul]" in capsys.readouterr().out
    with timer.trace(str(tmp_path / "tr"), device="cpu"):
        torch.relu(y @ y)
    text = (tmp_path / "tr" / "trace.json").read_text()
    assert '"traceEvents"' in text and "aten::mm" in text
    assert 0 < timer.timeit(torch.mm, x, x, device="cpu") < 1.0
