"""Port parity of three-class training on the device-built rulebook
(model.host_plans=False), ring and exact aux interpolation: the transpose
plans (K13) and aux ring plans (K14) against the JAX package's
build_stride_plan_T / build_aux_plan and the C++ train rulebook, the
exact 3-NN (K15) against three_nn_interpolate, and forward_train's
losses, assignments and every gradient leaf against jax.grad of the JAX
forward_train on the same batch and weights.

The plain versions run here (CPU tensors). Tolerances: plans are integers
and equal; the exact 3-NN within 1e-3 of its largest output magnitude
(its float32 expanded-form distances round differently in another
operation order); losses 1e-4 relative, gradients 1e-3 relative L2 per
leaf, as tests/test_torch_train.py.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import sassd_tpu.config as jconfig  # noqa: E402
from sassd_tpu.core import targets as jtargets  # noqa: E402
from sassd_tpu.data.kitti import build_anchors as jax_build_anchors  # noqa: E402
from sassd_tpu.data.synthetic import make_random_batch as jax_random_batch  # noqa: E402
from sassd_tpu.models import detector as jdetector  # noqa: E402
from sassd_tpu.models import ssd_head as jhead  # noqa: E402
from sassd_tpu.ops import interpolate as jinterp  # noqa: E402
from sassd_tpu.ops import sparse as jsp  # noqa: E402
from sassd_tpu_torch import config, inference, weights  # noqa: E402
from sassd_tpu_torch.core import targets  # noqa: E402
from sassd_tpu_torch.data import kitti, synthetic  # noqa: E402
from sassd_tpu_torch.models import pswarp, ssd_head  # noqa: E402
from sassd_tpu_torch.models.detector import parse_losses  # noqa: E402
from sassd_tpu_torch.ops import interpolate as itp  # noqa: E402
from sassd_tpu_torch.ops import native  # noqa: E402
from sassd_tpu_torch.ops import sparse as sp  # noqa: E402
from test_torch_cuda import three_nn_edge_case  # noqa: E402
from test_torch_device_plans import SHAPE, batch_keys, jax_plan  # noqa: E402

LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3
INTERP_TOL = 1e-3
MODULES = ("vxnet", "bevnet", "head", "pswarp", "aux")
CLASSES = ("Car", "Pedestrian", "Cyclist")
# (sizes, matched, unmatched) of multi_config's anchors
ANCHORS = {"Car": ((1.6, 3.9, 1.56), 0.6, 0.45),
           "Pedestrian": ((0.6, 0.8, 1.73), 0.5, 0.35),
           "Cyclist": ((0.6, 1.76, 1.73), 0.5, 0.35)}


def three_class(mod, aux_interp="ring"):
    """tiny_config() with the three classes of multi_config() on the tiny
    anchor grid, device plans and the given aux interpolation, from the
    config module `mod` (the port's or the JAX package's)."""
    base = mod.tiny_config()
    anchors = {name: mod.AnchorConfig(sizes=sizes, strides=(0.8, 0.8, 1.0),
                                      offsets=(0.4, -2.8, -1.0),
                                      matched_threshold=mt,
                                      unmatched_threshold=ut)
               for name, (sizes, mt, ut) in ANCHORS.items()}
    return dataclasses.replace(
        base, anchors=anchors,
        model=dataclasses.replace(base.model, num_class=3, host_plans=False,
                                  aux_interp=aux_interp),
        data=dataclasses.replace(base.data, class_names=CLASSES))


def level_shapes(cfg):
    shapes = [cfg.sparse_shape]
    for _ in range(3):
        shapes.append(sp.out_shape_stride2(shapes[-1]))
    return shapes


def tiny_scans(seed, batch_size=2):
    cfg = config.tiny_config()
    return cfg, synthetic.make_random_batch(
        cfg, np.random.default_rng(seed), batch_size=batch_size,
        n_points=900)


@pytest.mark.parametrize("cap", [120, 40])
def test_stride_plan_T_matches_jax(cap):
    """The inverted forward plan == JAX build_stride_plan_T through the
    output level's map; cap 40 truncates the output level."""
    keys = batch_keys(2)
    kt = torch.from_numpy(keys)
    out_shape = sp.out_shape_stride2(SHAPE)
    out = sp.downsample_keys(kt, SHAPE, cap)
    plan = sp.window_plan(out, out_shape, sp.build_index_map(kt, SHAPE),
                          SHAPE, 2)
    got = sp.stride_plan_T(plan, keys.shape[1]).numpy()
    for b in range(2):
        k = jnp.asarray(keys[b])
        okeys = jsp.downsample_keys(k, SHAPE, cap)
        omap = jsp.build_index_map(okeys, out_shape, keys_sorted=True)
        ref = jsp.build_stride_plan_T(k, SHAPE, omap, out_rows_cap=cap)
        np.testing.assert_array_equal(got[b], jax_plan(ref))
    assert got.dtype == np.int32 and (got >= 0).sum() > 100


@pytest.mark.parametrize("level", [1, 2, 3])
def test_stride_plan_T_matches_host_rulebook(level):
    cfg, batch = tiny_scans(6)
    plan = torch.from_numpy(batch[f"plan_stride{level}"].astype(np.int32))
    m_in = batch[f"plan_strideT{level}"].shape[2]
    got = sp.stride_plan_T(plan, m_in).numpy()
    np.testing.assert_array_equal(
        got, batch[f"plan_strideT{level}"].astype(np.int32))
    assert (got >= 0).sum() > 0


@pytest.mark.parametrize("level", [1, 2, 3])
def test_aux_plan_matches_jax_and_host_rulebook(level):
    """aux{L} of the port == JAX build_aux_plan == the C++ aux plan, as
    keys of the level (and bitwise, the levels being equal)."""
    cfg, batch = tiny_scans(7)
    shapes = level_shapes(cfg)
    keys0 = sp.coords_to_keys(torch.from_numpy(batch["coords"]), shapes[0])
    keys = keys0
    for lvl in range(1, level + 1):
        keys = sp.downsample_keys(keys, shapes[lvl - 1],
                                  cfg.caps.level_caps[lvl])
    imap = sp.build_index_map(keys, shapes[level])
    cell0 = torch.from_numpy(batch["coords"])
    got = sp.aux_plan(cell0, level, imap, shapes[level]).numpy()
    host = batch[f"plan_aux{level}"].astype(np.int32)
    np.testing.assert_array_equal(got, host)
    hkeys = sp.coords_to_keys(torch.from_numpy(
        batch[f"plan_coords{level}"]), shapes[level]).numpy()
    for b in range(2):
        jmap = jsp.build_index_map(jnp.asarray(keys[b].numpy()),
                                   shapes[level], keys_sorted=True)
        ref = np.asarray(jsp.build_aux_plan(jnp.asarray(batch["coords"][b]),
                                            level, jmap, shapes[level]))
        as_keys = [np.where(p >= 0, hkeys[b][np.maximum(p, 0)], -1)
                   for p in (got[b], ref, host[b])]
        np.testing.assert_array_equal(as_keys[0], as_keys[1])
        np.testing.assert_array_equal(as_keys[0], as_keys[2])
    assert (got >= 0).sum() > 100
    assert (got[:, :, (batch["coords"][0, :, 0] < 0)] == -1).all()


@pytest.mark.parametrize("maker", ["host", "device", "banded"])
def test_aux_plans_of_padded_queries_are_missing(maker):
    """Every maker of the aux ring plans writes -1 for all 27 taps of a
    padded level-0 row (K11 reads no plan for one): the C++ host rulebook
    past the voxelizer's compact rows (scans that fill about 40% of the
    slots), K14's plain version with padding between valid rows, and the
    banded stage's plans on band rows (K14 through the device rulebook,
    each band's padding past its members)."""
    from sassd_tpu_torch.models import backbone
    from sassd_tpu_torch.parallel import sparse_spatial as ss
    from test_torch_banded import band_rows
    if maker == "banded":
        cfg, spec, bc, _, _, _ = band_rows(3)
        shapes = backbone.level_shapes(ss.band_shape(cfg, spec))
        cell0 = bc.reshape(-1, bc.shape[2], 3)
        plans = sp.device_rulebook(
            sp.coords_to_keys(cell0, shapes[0]), shapes, spec.caps[1:],
            train=True, y_top=ss.y_top_rows(cfg, spec, 2, "cpu"))
        auxs = [plans[f"aux{lvl}"] for lvl in (1, 2, 3)]
    else:
        cfg = config.tiny_config()
        batch = synthetic.make_random_batch(cfg, np.random.default_rng(40),
                                            batch_size=2, n_points=200)
        cell0 = torch.from_numpy(batch["coords"])
        if maker == "host":
            auxs = [torch.from_numpy(batch[f"plan_aux{lvl}"].astype(np.int32))
                    for lvl in (1, 2, 3)]
        else:
            shapes = level_shapes(cfg)
            keys = sp.coords_to_keys(cell0, shapes[0])
            cell0 = cell0.clone()
            cell0[:, 1::4] = -1                       # padding in between
            auxs = []
            for lvl in (1, 2, 3):
                keys = sp.downsample_keys(keys, shapes[lvl - 1],
                                          cfg.caps.level_caps[lvl])
                auxs.append(sp.aux_plan(cell0, lvl, sp.build_index_map(
                    keys, shapes[lvl]), shapes[lvl]))
    padded = cell0[..., 0] < 0
    assert 0.2 < padded.float().mean() < 0.9
    for aux in auxs:
        taps = aux.transpose(1, 2)                    # [B, M0, 27]
        assert (taps[padded] == -1).all()
        assert (taps[~padded] >= 0).any()

@pytest.mark.parametrize("aux", [True, False])
def test_device_rulebook_train_matches_host_rulebook(aux):
    """device_rulebook(train=True) == build_plans_cpp(train=True), key for
    key: the aux plans only with `aux` (the exact aux builds none)."""
    cfg, batch = tiny_scans(4)
    shapes = level_shapes(cfg)
    keys0 = sp.coords_to_keys(torch.from_numpy(batch["coords"]), shapes[0])
    got = sp.device_rulebook(keys0, shapes, cfg.caps.level_caps[1:],
                             train=True, aux=aux)
    want = {k[5:] for k in batch if k.startswith("plan_")
            and k != "plan_subm3" and (aux or not k.startswith("plan_aux"))}
    assert set(got) == want
    for k, v in got.items():
        assert v.dtype == torch.int32, k
        np.testing.assert_array_equal(
            v.numpy(), batch[f"plan_{k}"].astype(np.int32), err_msg=k)
    caps = (cfg.voxel.max_voxels,) + tuple(cfg.caps.level_caps[1:])
    cpp = native.build_plans_cpp(batch["coords"][1], cfg.sparse_shape, caps,
                                 train=True)
    np.testing.assert_array_equal(got["strideT2"][1].numpy(),
                                  cpp["strideT2"])


def interp_inputs(seed, level):
    """Voxel centroids of a tiny batch (queries) and a level's cell
    centres, validity and random features (|u| <= 7 m)."""
    cfg, batch = tiny_scans(seed)
    shapes = level_shapes(cfg)
    keys = sp.coords_to_keys(torch.from_numpy(batch["coords"]), shapes[0])
    for lvl in range(1, level + 1):
        keys = sp.downsample_keys(keys, shapes[lvl - 1],
                                  cfg.caps.level_caps[lvl])
    coords = sp.keys_to_coords(keys, shapes[level]).numpy()
    vs = np.asarray(cfg.voxel.voxel_size, np.float32) * 2 ** level
    pcr = np.asarray(cfg.voxel.point_cloud_range[:3], np.float32)
    centers = ((coords[..., ::-1].astype(np.float32) + 0.5) * vs + pcr)
    nums = batch["num_points"]
    query = (batch["voxels"][..., :3].sum(-2)
             / np.maximum(nums, 1)[..., None]).astype(np.float32)
    rng = np.random.default_rng(seed + level)
    feats = rng.normal(size=coords.shape[:2] + (16,)).astype(np.float32)
    return (query, centers.astype(np.float32),
            keys.numpy() != sp.INVALID_KEY, feats, nums > 0)


def jax_three_nn(q, k, v, f):
    return jnp.stack([jinterp.three_nn_interpolate(q[b], k[b], v[b], f[b])
                      for b in range(q.shape[0])])


@pytest.mark.parametrize("level", [1, 2, 3, "ties", "coincident",
                                   "few_valid"])
def test_three_nn_plain_matches_jax(level):
    """The plain exact 3-NN against JAX three_nn_interpolate on the tiny
    config's levels and on K15's edge cases (tests/test_torch_cuda.py):
    equal known points across slice boundaries, queries on known points,
    and samples with 2 and 0 valid known rows (padding rows win by the
    lowest index, as top_k's)."""
    if isinstance(level, int):
        q, k, v, f, qvalid = interp_inputs(8, level)
    else:
        q, k, v, f, _ = three_nn_edge_case(level)
        qvalid = np.ones(q.shape[:2], bool)
    ref = np.asarray(jax_three_nn(*map(jnp.asarray, (q, k, v, f))))[qvalid]
    got = itp.three_nn_interpolate(*map(torch.from_numpy, (q, k, v, f)))
    got = got.numpy()[qvalid]
    scale = np.abs(ref).max()
    assert scale > 0.1
    assert np.abs(got - ref).max() <= INTERP_TOL * scale
    rows, w = itp.three_nn_select_plain(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(w.sum(1).numpy(), 1.0, rtol=1e-6)
    assert (rows.numpy() // k.shape[1] == np.repeat(
        np.arange(2), q.shape[1])[:, None]).all()


def plain_d2(q, k, v):
    """[N, M] float32 squared distances of one sample, the float32
    operations of three_nn_select_plain in its order."""
    kx, ky, kz = (k[None, :, i] for i in range(3))
    ux, uy, uz = (q[:, i:i + 1] for i in range(3))
    k2 = kx * kx + ky * ky + kz * kz
    dot = ux * kx + uy * ky + uz * kz
    bias = torch.where(v, 0.0, 1e10).to(torch.float32)[None]
    return (torch.clamp((ux * ux + uy * uy + uz * uz + k2) - 2.0 * dot,
                        min=0.0) + bias).numpy()


def lex_top3(d2, rows):
    """The (d2, index) lexicographic top 3 of the distinct `rows` of one
    query's [M] distances."""
    rows = np.unique(rows)
    return rows[np.lexsort((rows, d2[rows]))[:3]]


def slice_merge_top3(d2, slices, stride=None):
    """K15's selection on one query's [M] distances: each of `slices`
    slices of the known rows keeps its top 3 among its rows and, with
    `stride`, the 3 seed rows (the top 3 of rows 0, stride, 2 * stride,
    ...); then the top 3 of the partials, copies dropped."""
    m = len(d2)
    seeds = lex_top3(d2, np.arange(0, m, stride)) if stride else []
    per = -(-m // slices)
    parts = [lex_top3(d2, np.concatenate([np.arange(s0, min(s0 + per, m)),
                                          seeds]).astype(np.int64))
             for s0 in range(0, m, per)]
    return lex_top3(d2, np.concatenate(parts))


@pytest.mark.parametrize("case", ["tiny", "ties", "coincident", "few_valid"])
def test_three_nn_slice_merge_equals_unsplit(case):
    """The invariant K15 relies on: the lexicographic merge of slice-wise
    top 3s of the plain version's distances, each slice also seeded with
    the top 3 of a strided sample of the rows, is its unsplit selection,
    for any slice count and sample, ties included (equal points across
    slice boundaries, coincident queries, padding rows at one point)."""
    if case == "tiny":
        q, k, v, _, _ = interp_inputs(8, 1)
    else:
        q, k, v, _, _ = three_nn_edge_case(case)
    rows, _ = itp.three_nn_select_plain(*map(torch.from_numpy, (q, k, v)))
    n, m = q.shape[1], k.shape[1]
    rows = rows.numpy().reshape(2, n, 3) - (np.arange(2) * m)[:, None, None]
    for b in range(2):
        d2 = plain_d2(*map(torch.from_numpy, (q[b], k[b], v[b])))
        np.testing.assert_array_equal(
            np.argsort(d2, axis=1, kind="stable")[:, :3], rows[b])
        for i in range(0, n, 5):
            for slices in (2, 3, 4, 7, 20):
                for stride in (None, 1, 5, m):
                    np.testing.assert_array_equal(
                        slice_merge_top3(d2[i], slices, stride), rows[b, i])


def test_three_nn_grad_matches_jax():
    """d(out . cot)/d(feats), the only gradient, against jax.grad."""
    q, k, v, f, qvalid = interp_inputs(9, 1)
    cot = np.random.default_rng(3).normal(
        size=q.shape[:2] + (f.shape[-1],)).astype(np.float32)
    cot *= qvalid[..., None]
    jq, jk, jv, jc = map(jnp.asarray, (q, k, v, cot))
    ref = np.asarray(jax.grad(lambda ff: jnp.sum(
        jax_three_nn(jq, jk, jv, ff) * jc))(jnp.asarray(f)))
    ft = torch.from_numpy(f).requires_grad_()
    itp.three_nn_interpolate(*map(torch.from_numpy, (q, k, v)), ft).backward(
        torch.from_numpy(cot))
    got = ft.grad.numpy()
    assert np.abs(ref).max() > 0.1
    assert np.abs(got - ref).max() <= INTERP_TOL * np.abs(ref).max()


def jax_weights(cfg, seed=7, gain=weights.RELU_GAIN):
    params, state = jdetector.detector_init(jax.random.PRNGKey(seed), cfg)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: np.asarray(v) * (gain if p[-1].key == "w" else 1.0),
        params)
    return params, jax.tree_util.tree_map(np.asarray, state)


def leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def three_class_batch(make, cfg):
    """A tiny random batch with its three GTs of classes 1, 2 and 3."""
    batch = make(cfg, np.random.default_rng(5), batch_size=2, n_points=900)
    g = batch["gt_classes"].shape[1]
    batch["gt_classes"] = np.where(batch["gt_valid"], 1 + np.arange(g) % 3,
                                   0).astype(np.int32)
    return batch


def test_three_class_weights_and_anchors_match_jax():
    """The three-class head converts both ways unchanged, and the anchors
    are JAX's class-major [3 * H * W * 2, 7]."""
    cfg, jcfg = three_class(config), three_class(jconfig)
    params, state = jax_weights(jcfg)
    model = weights.from_jax(cfg, params, state, "cpu")
    p2, s2 = weights.to_jax(model)
    for ref, got in ((params, p2), (state, s2)):
        ref, got = leaves(ref), leaves(got)
        assert ref.keys() == got.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert p2["head"]["conv_cls"]["w"].shape[-1] == 3 * 2 * 3
    for a, b in zip(kitti.build_anchors(cfg), jax_build_anchors(jcfg)):
        np.testing.assert_array_equal(a, b)
    h, w = cfg.bev_map_size
    assert kitti.build_anchors(cfg)[0].shape == (3 * h * w * 2, 7)
    mc = config.multi_config()
    assert mc.num_anchors == 211200 and mc.class_names == CLASSES


@pytest.fixture(scope="module", params=["ring", "exact"])
def step_pair(request):
    """One three-class forward_train + backward on device plans in both
    packages on the same batch and weights, plus both assignments."""
    aux = request.param
    cfg, jcfg = three_class(config, aux), three_class(jconfig, aux)
    params, state = jax_weights(jcfg)
    batch = three_class_batch(synthetic.make_random_batch, cfg)
    jbatch = {k: jnp.asarray(v) for k, v in three_class_batch(
        jax_random_batch, jcfg).items()}
    assert not any(k.startswith("plan_") for k in batch)
    anchors = kitti.build_anchors(cfg)[0]
    janchors = jnp.asarray(anchors)
    a_cls = anchors.shape[0] // 3
    thr = [(a.matched_threshold, a.unmatched_threshold)
           for a in cfg.anchors.values()]

    def loss_fn(p):
        losses, new_state = jdetector.forward_train(p, state, jbatch,
                                                    janchors, jcfg)
        return jdetector.parse_losses(losses)[0], (losses, new_state)

    grads, (jlosses, jstate) = jax.jit(jax.grad(loss_fn, has_aux=True))(
        params)

    @jax.jit
    def assign(p):
        spine = jdetector.forward_spine(p, state, jbatch, jcfg, train=True)
        outs = jhead.head_apply(p["head"], spine.bev_map, 3, 7, 2)
        rpn = []
        for c in range(3):
            sl = slice(c * a_cls, (c + 1) * a_cls)
            rpn.append(jax.vmap(lambda m, g, v, gc: jtargets.create_targets(
                janchors[sl], g, v & (gc == c + 1),
                jtargets.nearest_iou_similarity, *thr[c],
                anchors_mask=m[sl], gt_classes=gc).labels)(
                jbatch["anchors_mask"], jbatch["gt_boxes"],
                jbatch["gt_valid"], jbatch["gt_classes"]))
        ga = jhead.get_guided_anchors(
            outs, janchors, jbatch["anchors_mask"], num_class=3, thr=0.1,
            cap=jcfg.caps.guided_train, gt_boxes=jbatch["gt_boxes"],
            gt_labels=jbatch["gt_classes"], gt_valid=jbatch["gt_valid"])
        warp = jax.vmap(lambda bx, v, g, gv: jtargets.create_targets(
            bx, g, gv, jtargets.rotate_iou3d_similarity, 0.7, 0.7,
            anchors_mask=v).labels)(ga.boxes, ga.valid, jbatch["gt_boxes"],
                                    jbatch["gt_valid"])
        return jnp.concatenate(rpn, 1), ga.valid, warp

    jassign = [np.asarray(x) for x in assign(params)]

    model = weights.from_jax(cfg, params, state, "cpu")
    model.train()
    tb = inference.to_device(batch, "cpu")
    at = torch.from_numpy(anchors)
    with torch.no_grad():
        spine = model.forward_spine(tb)
        assert (spine.aux_plans is not None) == (aux == "ring")
        outs = model.head(spine.bev_map)
        rpn = []
        for c in range(3):
            sl = slice(c * a_cls, (c + 1) * a_cls)
            gv = tb["gt_valid"] & (tb["gt_classes"] == c + 1)
            rpn.append(torch.stack([targets.create_targets(
                at[sl], tb["gt_boxes"][i], gv[i],
                targets.nearest_iou_similarity, *thr[c],
                anchors_mask=tb["anchors_mask"][i, sl],
                gt_classes=tb["gt_classes"][i]).labels for i in range(2)]))
        ga = ssd_head.get_guided_anchors(
            outs, at, tb["anchors_mask"], num_class=3, thr=0.1,
            cap=cfg.caps.guided_train, gt_boxes=tb["gt_boxes"],
            gt_labels=tb["gt_classes"], gt_valid=tb["gt_valid"])
        warp = pswarp.pswarp_labels(ga.boxes, ga.valid, tb["gt_boxes"],
                                    tb["gt_valid"])
    model = weights.from_jax(cfg, params, state, "cpu")   # fresh BN state
    model.train()
    losses = model.forward_train(tb, at)
    parse_losses(losses).backward()
    return dict(jlosses={k: float(v) for k, v in jlosses.items()},
                jgrads=leaves(grads), jstate=leaves(jstate),
                jassign=jassign,
                assign=[torch.cat(rpn, 1).numpy(), ga.valid.numpy(),
                        warp.numpy()],
                losses={k: float(v.detach()) for k, v in losses.items()},
                grads=leaves(weights.grads_to_jax(model)),
                state=leaves(weights.to_jax(model)[1]))


def test_three_class_assignments_match_jax(step_pair):
    """Per-class anchor labels, guided-candidate validity and PSWarp
    labels are equal, and every class has positive anchors."""
    for name, got, ref in zip(("rpn", "guided valid", "pswarp"),
                              step_pair["assign"], step_pair["jassign"]):
        np.testing.assert_array_equal(got, ref, err_msg=name)
    labels = step_pair["jassign"][0]
    assert set(np.unique(labels[labels > 0])) == {1, 2, 3}


def test_three_class_losses_match_jax(step_pair):
    ref, got = step_pair["jlosses"], step_pair["losses"]
    assert set(ref) <= set(got)
    for k, v in ref.items():
        assert np.isfinite(v) and v != 0.0, k
        np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, err_msg=k)


@pytest.mark.parametrize("module", MODULES)
def test_three_class_grads_match_jax(step_pair, module):
    """Every gradient leaf of the module within 1e-3 relative L2."""
    ref = {k: v for k, v in step_pair["jgrads"].items()
           if k.startswith(f"['{module}']")}
    got = step_pair["grads"]
    assert ref and set(ref) <= set(got)
    for k, r in ref.items():
        norm = np.linalg.norm(r)
        assert norm > 0, k
        err = np.linalg.norm(got[k] - r) / norm
        assert err <= GRAD_RTOL, (k, err)


def test_three_class_bn_state_matches_jax(step_pair):
    """The masked BatchNorm saw the device levels' rows: running buffers
    equal JAX's."""
    ref, got = step_pair["jstate"], step_pair["state"]
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
