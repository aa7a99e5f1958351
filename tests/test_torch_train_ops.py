"""Port parity of the differentiable operations of training on
tiny_config(), against the JAX package's functions and jax.grad, through
the plain versions the CPU runs (the card's kernels are held to these in
tests/test_torch_cuda.py and chip_smoke.py):

- sparse convs (subm with the symmetric custom VJP, stride with the host
  transpose plan) on train host plans, values and both gradients;
- densify and the level-3 row gather (gather_mid), gradients;
- the ring 3-NN interpolation, values and feature gradients;
- points in boxes and the aux targets, bitwise;
- the PSWarp scores' gradients in the part map and the boxes;
- the masked train-mode BatchNorm, outputs and running state.

Tolerances: 1e-5 relative to the largest magnitude for float32 sums in
another order; exact where only selections, copies and comparisons run.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from sassd_tpu.core import boxes as jboxes  # noqa: E402
from sassd_tpu.models import backbone as jbackbone  # noqa: E402
from sassd_tpu.models import layers as jlayers  # noqa: E402
from sassd_tpu.ops import interpolate as jinterp  # noqa: E402
from sassd_tpu.ops import sparse as jsp  # noqa: E402
from sassd_tpu.ops import warp as jwarp  # noqa: E402
from sassd_tpu_torch import config  # noqa: E402
from sassd_tpu_torch.core import boxes  # noqa: E402
from sassd_tpu_torch.data import synthetic  # noqa: E402
from sassd_tpu_torch.models import layers  # noqa: E402
from sassd_tpu_torch.ops import interpolate, sparse as sp, warp  # noqa: E402
from test_torch_cuda import k5_edge_case  # noqa: E402

RTOL = 1e-5


def close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(got - ref).max() <= rtol * scale, \
        np.abs(got - ref).max() / scale


@pytest.fixture(scope="module")
def train_batch():
    cfg = config.tiny_config()
    batch = synthetic.make_random_batch(cfg, np.random.default_rng(2),
                                        batch_size=2, n_points=900)
    caps = (cfg.voxel.max_voxels,) + tuple(cfg.caps.level_caps[1:])
    return cfg, batch, caps


def jplan(arr):
    return jsp.SubmPlan(jnp.maximum(jnp.asarray(arr), 0).astype(jnp.int32),
                        jnp.asarray(arr) >= 0)


def t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


@pytest.mark.parametrize("kind,level,cin,cout", [
    ("subm", 0, 16, 16), ("subm", 1, 32, 32), ("subm", 2, 64, 64),
    ("stride", 1, 16, 32), ("stride", 2, 32, 64), ("stride", 3, 64, 64)])
def test_sparse_conv_grads_match_jax(train_batch, kind, level, cin, cout):
    """Values and both gradients of a conv on the level's train plans:
    subm through the JAX symmetric custom VJP, stride through
    stride_conv_hostT and the host transpose plan."""
    _, batch, caps = train_batch
    rng = np.random.default_rng(level + (10 if kind == "stride" else 0))
    plan = batch[f"plan_{kind}{level}"]
    m_in = caps[level] if kind == "subm" else caps[level - 1]
    x = rng.normal(size=(2, m_in, cin)).astype(np.float32)
    w = (rng.normal(size=(27, cin, cout)) / np.sqrt(27 * cin)).astype(
        np.float32)
    cot = rng.normal(size=(2, plan.shape[2], cout)).astype(np.float32)
    if kind == "subm":
        def jfn(xx, ww):
            return jsp.subm_conv_batched(xx, ww, jplan(plan), symmetric=True,
                                         triple=True)
        fn = lambda xx, ww: sp.subm_conv_sym(xx, ww, t(plan))  # noqa: E731
    else:
        plan_t = batch[f"plan_strideT{level}"]

        def jfn(xx, ww):
            return jsp.stride_conv_hostT_batched(
                jnp.float32, True, False, xx, ww, jplan(plan), jplan(plan_t))
        fn = lambda xx, ww: sp.stride_conv_hostT(  # noqa: E731
            xx, ww, t(plan), t(plan_t))
    ref, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(cot))
    xt, wt = t(x, True), t(w, True)
    out = fn(xt, wt)
    out.backward(t(cot))
    close(out.detach(), ref)
    close(xt.grad, jdx)
    close(wt.grad, jdw)
    # the weight gradient the card computes with K10, in its plain form
    close(sp.conv_weight_grad_plain(t(x), t(plan), t(cot)), jdw)
    assert np.abs(np.asarray(jdx)).max() > 0


def edge_plan(plan, case):
    """A wire plan [B, 27, M] made into one of the edge cases of the card
    kernels' tap skipping: a tap found for no row, a 64-row tile (rows
    64..127) with no found row, or sample 1 all padding."""
    p = np.array(plan)
    if case == "tap_never_found":
        p[:, 13] = -1
    elif case == "empty_tile":
        p[..., 64:128] = -1
    elif case == "padded_sample":
        p[1] = -1
    return p


@pytest.mark.parametrize("kind,level_in,cin,cout,dtype,case", [
    ("subm0", 0, 4, 16, np.int16, "tap_never_found"),
    ("subm2", 2, 64, 64, np.int32, "tap_never_found"),
    ("subm1", 1, 32, 32, np.int32, "empty_tile"),
    ("stride2", 1, 32, 64, np.int16, "empty_tile"),
    ("subm0", 0, 16, 16, np.int32, "padded_sample"),
    ("stride3", 2, 64, 64, np.int16, "padded_sample")])
def test_conv_weight_grad_edge_plans_match_jax(train_batch, kind, level_in,
                                               cin, cout, dtype, case):
    """The plain K10 path (int16 or int32 plans) on the edge-case plans of
    tap skipping == the weight gradient of JAX subm_conv_batched (jax.vjp,
    unpacked gather); a tap found for no row gets a zero gradient."""
    _, batch, caps = train_batch
    rng = np.random.default_rng(cin * cout + level_in)
    plan = edge_plan(batch[f"plan_{kind}"], case).astype(dtype)
    x = rng.normal(size=(2, caps[level_in], cin)).astype(np.float32)
    w = (rng.normal(size=(27, cin, cout)) / np.sqrt(27 * cin)).astype(
        np.float32)
    cot = rng.normal(size=(2, plan.shape[2], cout)).astype(np.float32)
    _, vjp = jax.vjp(lambda ww: jsp.subm_conv_batched(
        jnp.asarray(x), ww, jplan(plan.astype(np.int32)), symmetric=False,
        triple=False), jnp.asarray(w))
    (jdw,) = vjp(jnp.asarray(cot))
    got = sp.conv_weight_grad_plain(t(x), t(plan), t(cot))
    close(got, jdw)
    if case == "tap_never_found":
        assert not got[13].any()
    assert np.abs(np.asarray(jdw)).max() > 0


@pytest.mark.parametrize("case", ["tiny", "w_not_4", "empty_row"])
def test_densify_grad_matches_jax(train_batch, case):
    """The canvas gradient at the rows (autograd of densify_nchw and the
    plain K5b) == jax.vjp of to_dense + the d-major transpose, exact: the
    train batch's level 3, a grid whose W is not a multiple of 4, and a
    batch whose sample 1 is all padding."""
    cfg, batch, caps = train_batch
    c = 64 if case == "tiny" else 24
    if case == "tiny":
        shape3 = cfg.sparse_shape
        for _ in range(3):
            shape3 = sp.out_shape_stride2(shape3)
        keys = sp.coords_to_keys(t(batch["plan_coords3"]), shape3)
    else:
        shape3, keys, _ = k5_edge_case(case, c)
        keys = t(keys)
    rng = np.random.default_rng(4)
    x = rng.normal(size=tuple(keys.shape) + (c,)).astype(np.float32)
    d, h, w = shape3
    cot = rng.normal(size=(2, d * c, h, w)).astype(np.float32)

    def jfn(xx):
        dense = jax.vmap(lambda k, f: jsp.to_dense(k, f, shape3))(
            jnp.asarray(keys.numpy()), xx)                    # [B,D,H,W,C]
        return jnp.transpose(dense, (0, 1, 4, 2, 3)).reshape(2, d * c, h, w)
    _, vjp = jax.vjp(jfn, jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(cot))
    xt = t(x, True)
    canvas, occ = sp.densify_nchw(keys, xt, shape3)
    canvas.backward(t(cot))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jdx))
    np.testing.assert_array_equal(
        sp.densify_grad_plain(keys, t(cot), shape3).numpy(), np.asarray(jdx))
    assert not occ.requires_grad
    assert np.abs(np.asarray(jdx)).max() > 1.0
    if case == "empty_row":
        assert not xt.grad[1].any()


def test_gather_mid_grad_matches_jax(train_batch):
    cfg, batch, caps = train_batch
    shape3 = cfg.sparse_shape
    for _ in range(3):
        shape3 = sp.out_shape_stride2(shape3)
    rng = np.random.default_rng(5)
    keys = sp.coords_to_keys(t(batch["plan_coords3"]), shape3)
    dense = rng.normal(size=(2,) + shape3 + (64,)).astype(np.float32)
    cot = rng.normal(size=(2, caps[3], 64)).astype(np.float32)
    ref, vjp = jax.vjp(lambda dd: jbackbone._gather_mid(
        jnp.asarray(keys.numpy()), dd, shape3)[1], jnp.asarray(dense))
    (jdd,) = vjp(jnp.asarray(cot))
    dt = t(dense, True)
    got = sp.gather_rows(keys, dt.permute(0, 1, 4, 2, 3))
    got.backward(t(cot))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))
    np.testing.assert_array_equal(dt.grad.numpy(), np.asarray(jdd))


@pytest.mark.parametrize("level", [1, 2, 3])
def test_ring_interpolation_matches_jax(train_batch, level):
    """Values and feature gradients of neighborhood_interpolate_cells on
    the train aux plans, queries at the voxel centroids."""
    cfg, batch, caps = train_batch
    rng = np.random.default_rng(20 + level)
    c = 32 if level == 1 else 64
    feats = rng.normal(size=(2, caps[level], c)).astype(np.float32)
    npts = np.maximum(batch["num_points"], 1)[..., None].astype(np.float32)
    query = (batch["voxels"][..., :3].sum(-2) / npts).astype(np.float32)
    cell0, plan = batch["coords"], batch[f"plan_aux{level}"]
    vs = (np.asarray(cfg.voxel.voxel_size, np.float32) * 2 ** level)
    pcr = np.asarray(cfg.voxel.point_cloud_range[:3], np.float32)
    cot = rng.normal(size=(2, cell0.shape[1], c)).astype(np.float32)

    def jfn(f):
        return jax.vmap(lambda q, c0, ff, pl: jinterp.
                        neighborhood_interpolate_cells(q, c0, level, ff, pl,
                                                       vs, pcr))(
            jnp.asarray(query), jnp.asarray(cell0), f,
            jnp.asarray(plan).astype(jnp.int32))
    ref, vjp = jax.vjp(jfn, jnp.asarray(feats))
    (jdf,) = vjp(jnp.asarray(cot))
    ft = t(feats, True)
    got = interpolate.neighborhood_interpolate_cells(
        t(query), t(cell0), level, ft, t(plan), vs.tolist(), pcr.tolist())
    got.backward(t(cot))
    close(got.detach(), ref)
    close(ft.grad, jdf)
    valid = batch["coords"][..., 0] >= 0
    assert np.abs(np.asarray(ref)[valid]).min(axis=-1).max() > 0



@pytest.mark.parametrize("level", [1, 2, 3])
def test_ring_interpolation_with_padding_matches_jax(level):
    """neighborhood_interpolate_cells with padded queries mixed in (scans
    of 200 points fill about 40% of the 512 slots, the C++ host plans'
    rows past them): values and feature gradients as JAX's, zero output
    and no gradient from a padded query."""
    cfg = config.tiny_config()
    batch = synthetic.make_random_batch(cfg, np.random.default_rng(30),
                                        batch_size=2, n_points=200)
    caps = (cfg.voxel.max_voxels,) + tuple(cfg.caps.level_caps[1:])
    rng = np.random.default_rng(30 + level)
    c = 32 if level == 1 else 64
    feats = rng.normal(size=(2, caps[level], c)).astype(np.float32)
    npts = np.maximum(batch["num_points"], 1)[..., None].astype(np.float32)
    query = (batch["voxels"][..., :3].sum(-2) / npts).astype(np.float32)
    cell0, plan = batch["coords"], batch[f"plan_aux{level}"]
    padded = cell0[..., 0] < 0
    assert 0.3 < padded.mean() < 0.9
    vs = (np.asarray(cfg.voxel.voxel_size, np.float32) * 2 ** level)
    pcr = np.asarray(cfg.voxel.point_cloud_range[:3], np.float32)
    cot = rng.normal(size=(2, cell0.shape[1], c)).astype(np.float32)

    def jfn(f):
        return jax.vmap(lambda q, c0, ff, pl: jinterp.
                        neighborhood_interpolate_cells(q, c0, level, ff, pl,
                                                       vs, pcr))(
            jnp.asarray(query), jnp.asarray(cell0), f,
            jnp.asarray(plan).astype(jnp.int32))
    ref, vjp = jax.vjp(jfn, jnp.asarray(feats))
    (jdf,) = vjp(jnp.asarray(cot))
    ft = t(feats, True)
    got = interpolate.neighborhood_interpolate_cells(
        t(query), t(cell0), level, ft, t(plan), vs.tolist(), pcr.tolist())
    got.backward(t(cot))
    close(got.detach(), ref)
    close(ft.grad, jdf)
    assert (got.detach().numpy()[padded] == 0).all()
    assert np.abs(np.asarray(ref)[~padded]).max() > 0.1
    ft.grad = None
    cot_valid = np.where(padded[..., None], 0.0, cot).astype(np.float32)
    interpolate.neighborhood_interpolate_cells(
        t(query), t(cell0), level, ft, t(plan), vs.tolist(),
        pcr.tolist()).backward(t(cot_valid))
    close(ft.grad, jdf)

def test_points_in_boxes_and_aux_targets_match_jax():
    """Flags, labels and offsets bitwise: centroid-like points around GT
    boxes, some boxes and points invalid."""
    rng = np.random.default_rng(6)
    b, n, g = 2, 300, 8
    gt = np.zeros((b, g, 7), np.float32)
    gt[..., 0] = rng.uniform(0.5, 6.0, (b, g))
    gt[..., 1] = rng.uniform(-3.0, 3.0, (b, g))
    gt[..., 2] = rng.uniform(-1.8, -1.5, (b, g))
    gt[..., 3:6] = rng.uniform([1.4, 3.2, 1.4], [1.9, 4.5, 1.8], (b, g, 3))
    gt[..., 6] = rng.uniform(-np.pi, np.pi, (b, g))
    gv = rng.uniform(size=(b, g)) < 0.8
    pts = np.stack([rng.uniform(0.0, 6.4, (b, n)), rng.uniform(-3.2, 3.2,
                    (b, n)), rng.uniform(-2.0, 0.5, (b, n))],
                   -1).astype(np.float32)
    pv = rng.uniform(size=(b, n)) < 0.9
    for i in range(b):
        jflags, jlabel, joff = jboxes.points_in_boxes3d(jnp.asarray(pts[i]),
                                                        jnp.asarray(gt[i]))
        flags, label, off = boxes.points_in_boxes3d(t(pts[i]), t(gt[i]))
        np.testing.assert_array_equal(flags.numpy(), np.asarray(jflags))
        np.testing.assert_array_equal(label.numpy(), np.asarray(jlabel))
        np.testing.assert_array_equal(off.numpy(), np.asarray(joff))
    label, off = boxes.aux_targets(t(pts), t(pv), t(gt), t(gv))
    for i in range(b):      # detector.aux_loss.targets_one
        flags = np.asarray(jboxes.points_in_boxes3d(
            jnp.asarray(pts[i]), jnp.asarray(gt[i]))[0]) & gv[i][None] \
            & pv[i][:, None]
        lab = flags.any(1)
        centers = gt[i, :, :3].copy()
        centers[:, 2] += gt[i, :, 5] * np.float32(0.5)
        ref = np.where(lab[:, None], pts[i] - centers[flags.argmax(1)], 0.0)
        np.testing.assert_array_equal(label[i].numpy(), lab)
        np.testing.assert_array_equal(off[i].numpy(), ref)
    assert 10 < int(label.sum()) < b * n


def test_pswarp_score_grads_match_jax():
    """Gradients of the mean part samples in the map and the boxes
    (x, y, w, l, yaw) against jax.grad of pswarp_apply's sampler."""
    rng = np.random.default_rng(7)
    b, k, h, w, n = 2, 28, 40, 36, 60
    img = rng.normal(size=(b, h, w, k)).astype(np.float32)
    bx = np.zeros((b, n, 7), np.float32)
    bx[..., 0] = rng.uniform(-1.0, 15.4, (b, n))
    bx[..., 1] = rng.uniform(-9.0, 9.0, (b, n))
    bx[..., 2] = -1.0
    bx[..., 3:6] = rng.uniform([1.4, 3.2, 1.4], [1.9, 4.5, 1.8], (b, n, 3))
    bx[..., 6] = rng.uniform(-np.pi, np.pi, (b, n))
    valid = rng.uniform(size=(b, n)) < 0.85
    cot = rng.normal(size=(b, n)).astype(np.float32)
    args = ((4, 7), (0.0, 8.0), 2.5)

    def jscore(im, boxes_):
        def one(ii, bb):
            xs, ys = jwarp.gen_sample_grid(bb[:, [0, 1, 3, 4, 6]], *args)
            return jnp.mean(jwarp.bilinear_sample_per_part_packed(ii, xs, ys),
                            axis=0)
        return jnp.where(jnp.asarray(valid), jax.vmap(one)(im, boxes_), 0.0)
    ref, vjp = jax.vjp(jscore, jnp.asarray(img), jnp.asarray(bx))
    jdi, jdb = vjp(jnp.asarray(cot))
    it, bt = t(img, True), t(bx, True)
    got = warp.pswarp_score(it.permute(0, 3, 1, 2), bt, t(valid), *args)
    got.backward(t(cot))
    close(got.detach(), ref)
    close(it.grad, jdi)
    close(bt.grad, jdb, rtol=1e-4)
    assert np.abs(np.asarray(jdb)[..., [0, 1, 3, 4, 6]]).min() >= 0
    assert not np.asarray(jdb)[..., [2, 5]].any()


@pytest.mark.parametrize("masked", [True, False])
def test_train_batch_norm_matches_jax(masked):
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(2, 50, 16)) * 3 + 1).astype(np.float32)
    mask = rng.uniform(size=(2, 50)) < 0.7
    p = dict(scale=rng.uniform(0.5, 1.5, 16).astype(np.float32),
             bias=rng.normal(size=16).astype(np.float32))
    s = dict(mean=rng.normal(size=16).astype(np.float32),
             var=rng.uniform(0.5, 2, 16).astype(np.float32))
    ref, new_s = jlayers.batch_norm(
        {k: jnp.asarray(v) for k, v in p.items()},
        {k: jnp.asarray(v) for k, v in s.items()}, jnp.asarray(x),
        train=True, mask=jnp.asarray(mask) if masked else None)
    bn = layers.BatchNorm(16)
    bn.load_state_dict({k: t(v) for k, v in {**p, **s}.items()})
    bn.train()
    got = bn(t(x), mask=t(mask)[..., None] if masked else None)
    close(got.detach(), ref)
    close(bn.mean, new_s["mean"])
    close(bn.var, new_s["var"])
    bn.eval()
    before = bn.mean.clone()
    bn(t(x))
    assert torch.equal(bn.mean, before)         # eval leaves the buffers
