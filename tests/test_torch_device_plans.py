"""Port parity for the device-built rulebook (model.host_plans=False):
index maps and window plans (K6; a scan's six plans in one call), the
sort-based downsample (K7),
keys_to_coords, the whole rulebook against the C++ host rulebook, the
backbone on device plans against the JAX package's vxnet_apply, and
forward_test with host_plans=False against a live JAX forward_test and
against the port's host-plans detections.

The plain versions run here (CPU tensors). Tolerances: plans, keys, maps
and coords are integers and must be equal; 1e-4 for backbone features
(float32 sums in another order); the golden-test ones for detections.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import sassd_tpu.config as jconfig  # noqa: E402
from sassd_tpu.data.synthetic import make_random_batch as jax_random_batch  # noqa: E402
from sassd_tpu.models import backbone as jbackbone  # noqa: E402
from sassd_tpu.models import detector as jdetector  # noqa: E402
from sassd_tpu.ops import sparse as jsp  # noqa: E402
from sassd_tpu_torch import config, inference, weights  # noqa: E402
from sassd_tpu_torch.data import kitti, synthetic  # noqa: E402
from sassd_tpu_torch.models.backbone import vfe_mean  # noqa: E402
from sassd_tpu_torch.ops import native  # noqa: E402
from sassd_tpu_torch.ops import sparse as sp  # noqa: E402
from test_torch_cuda import K7_CASES, k7_edge_case  # noqa: E402
from test_torch_detector import jax_weights, matched  # noqa: E402

SHAPE = (6, 10, 9)          # odd W exercises the x = w - 1 edge


def random_keys(rng, shape_zyx, n, cap):
    """[cap] sorted unique keys, INVALID padded, with x = 0 and x = w - 1
    cells forced in (the window lookup's x-alias hazard)."""
    d, h, w = shape_zyx
    lin = rng.choice(d * h * w, n, replace=False)
    edge = ((rng.integers(0, d, 8) * h + rng.integers(0, h, 8)) * w
            + np.repeat([0, w - 1], 4))
    lin = np.unique(np.concatenate([lin, edge]))[:n]
    keys = np.full((cap,), sp.INVALID_KEY, np.int32)
    keys[:len(lin)] = lin
    return keys


def batch_keys(seed, shape=SHAPE, n=(50, 70), cap=80):
    rng = np.random.default_rng(seed)
    return np.stack([random_keys(rng, shape, k, cap) for k in n])


def jax_plan(plan):
    return np.where(np.asarray(plan.found), np.asarray(plan.idx), -1)


def tiny_scans(seed, batch_size=2):
    cfg = config.tiny_config()
    return cfg, synthetic.make_random_batch(
        cfg, np.random.default_rng(seed), batch_size=batch_size,
        n_points=900)


def test_keys_to_coords_matches_jax():
    keys = batch_keys(0)
    got = sp.keys_to_coords(torch.from_numpy(keys), SHAPE).numpy()
    for b in range(2):
        np.testing.assert_array_equal(
            got[b], np.asarray(jsp.keys_to_coords(jnp.asarray(keys[b]),
                                                  SHAPE)))
    assert got.dtype == np.int32 and (got[:, -1] == -1).all()


def test_index_map_matches_jax():
    keys = batch_keys(1)
    got = sp.build_index_map(torch.from_numpy(keys), SHAPE).numpy()
    for b in range(2):
        ref = jsp.build_index_map(jnp.asarray(keys[b]), SHAPE,
                                  keys_sorted=True)
        np.testing.assert_array_equal(got[b], np.asarray(ref))


@pytest.mark.parametrize("kind", ["subm", "stride"])
def test_window_plans_match_jax(kind):
    """Port plans == JAX's dense-index window plans, as where(found, idx,
    -1), per sample of a batch of two."""
    keys = batch_keys(2)
    kt = torch.from_numpy(keys)
    imap = sp.build_index_map(kt, SHAPE)
    if kind == "subm":
        got = sp.window_plan(kt, SHAPE, imap, SHAPE, 1).numpy()
    else:
        out_shape = sp.out_shape_stride2(SHAPE)
        out = sp.downsample_keys(kt, SHAPE, 48)
        got = sp.window_plan(out, out_shape, imap, SHAPE, 2).numpy()
    for b in range(2):
        k = jnp.asarray(keys[b])
        jmap = jsp.build_index_map(k, SHAPE, keys_sorted=True)
        if kind == "subm":
            ref = jsp.build_subm_plan(k, SHAPE, index_map=jmap)
        else:
            ref = jsp.build_stride_plan(
                k, jsp.downsample_keys(k, SHAPE, 48), SHAPE, index_map=jmap)
        np.testing.assert_array_equal(got[b], jax_plan(ref))
    assert got.dtype == np.int32 and (got >= 0).sum() > 100


# a scan's six plans (window_plans over rulebook_plans' specs): batch 1,
# batch 2, and level caps that cut every level
SCAN_PLAN_CASES = {"b1": ((0,), (64, 40, 24)), "b2": ((0, 1), (64, 40, 24)),
                   "cap_cut": ((0, 1), (30, 12, 6))}


@pytest.mark.parametrize("case", sorted(SCAN_PLAN_CASES))
def test_scan_window_plans_match_jax(case):
    """window_plans over a scan's six specs (subm0-2 through the maps of
    levels 0-2, stride1-3 through the level below's) == window_plans_plain
    == JAX's build_subm_plan / build_stride_plan with index_map=, sample
    by sample, exactly."""
    rows, caps = SCAN_PLAN_CASES[case]
    keys = batch_keys(6)[list(rows)]
    shapes = [SHAPE]
    for _ in range(3):
        shapes.append(sp.out_shape_stride2(shapes[-1]))
    lk = [torch.from_numpy(keys)]
    for lvl in (1, 2, 3):
        lk.append(sp.downsample_keys(lk[-1], shapes[lvl - 1], caps[lvl - 1]))
    maps = [sp.build_index_map(k, s) for k, s in zip(lk[:3], shapes)]
    got = sp.rulebook_plans(lk, shapes, maps)
    specs = sp.rulebook_specs(lk, shapes, maps)
    assert [spec[4] for spec in specs] == [1, 2] * 3
    assert [spec[2] is maps[i // 2] for i, spec in enumerate(specs)] == (
        [True] * 6)
    plain = sp.window_plans_plain(specs)
    assert list(got) == list(sp.RULEBOOK_PLANS)
    for name, ref in zip(sp.RULEBOOK_PLANS, plain):
        assert torch.equal(got[name], ref), name
    for b in range(len(rows)):
        jk = [jnp.asarray(keys[b])]
        for lvl in (1, 2, 3):
            jk.append(jsp.downsample_keys(jk[-1], shapes[lvl - 1],
                                          caps[lvl - 1]))
        for lvl in range(3):
            np.testing.assert_array_equal(lk[lvl + 1][b].numpy(),
                                          np.asarray(jk[lvl + 1]))
            jmap = jsp.build_index_map(jk[lvl], shapes[lvl],
                                       keys_sorted=True)
            subm = jsp.build_subm_plan(jk[lvl], shapes[lvl], index_map=jmap)
            stride = jsp.build_stride_plan(jk[lvl], jk[lvl + 1],
                                           shapes[lvl], index_map=jmap)
            np.testing.assert_array_equal(got[f"subm{lvl}"][b].numpy(),
                                          jax_plan(subm))
            np.testing.assert_array_equal(got[f"stride{lvl + 1}"][b].numpy(),
                                          jax_plan(stride))
    assert all(v.dtype == torch.int32 for v in got.values())
    assert (got["subm0"] >= 0).sum() > 100 and (got["stride3"] >= 0).any()


@pytest.mark.parametrize("cap", [120, 40])
def test_downsample_keys_matches_jax(cap):
    """Sorted, capped active sets; cap 40 truncates (lowest keys win)."""
    keys = batch_keys(3)
    got = sp.downsample_keys(torch.from_numpy(keys), SHAPE, cap).numpy()
    for b in range(2):
        ref = np.asarray(jsp.downsample_keys(jnp.asarray(keys[b]), SHAPE,
                                             cap))
        np.testing.assert_array_equal(got[b], ref)
    n_valid = (got != sp.INVALID_KEY).sum(1)
    assert (n_valid == cap).all() if cap == 40 else (n_valid < cap).all()


@pytest.mark.parametrize("case", K7_CASES)
def test_downsample_keys_edge_cases_match_jax(case):
    """The plain K7 path == JAX downsample_keys (eager, per row, with
    y_limit_out) on K7's edge cases: caps that cut inside a bitmap tile or
    at the unique count, an all-padding row, the grid's last cell, limits 0
    and above the output height, an output grid of 3 words."""
    shape, keys, cap, y_limit = k7_edge_case(case)
    got = sp.downsample_keys(
        torch.from_numpy(keys), shape, cap,
        None if y_limit is None else torch.from_numpy(y_limit)).numpy()
    assert got.shape == (keys.shape[0], cap) and got.dtype == np.int32
    for b in range(keys.shape[0]):
        ref = jsp.downsample_keys(
            jnp.asarray(keys[b]), shape, cap,
            None if y_limit is None else int(y_limit[b]))
        np.testing.assert_array_equal(got[b], np.asarray(ref))
    n = (got != sp.INVALID_KEY).sum(1)
    assert (n.sum() == 0) == (case == "y_limit_0")
    assert (n[0] == cap) == case.startswith("cap_")


def test_device_rulebook_matches_host_rulebook():
    """The whole device rulebook (plain versions) == build_plans_cpp on
    voxelized tiny scans, after the int16 wire cast to int32."""
    cfg, batch = tiny_scans(4)
    shapes = [cfg.sparse_shape]
    for _ in range(3):
        shapes.append(sp.out_shape_stride2(shapes[-1]))
    keys0 = sp.coords_to_keys(torch.from_numpy(batch["coords"]), shapes[0])
    got = sp.device_rulebook(keys0, shapes, cfg.caps.level_caps[1:])
    # the device builds the inference rulebook: no train plans (aux,
    # strideT) and no level-3 subm plan
    assert sorted(got) == sorted(
        k[5:] for k in batch if k.startswith("plan_") and k != "plan_subm3"
        and not k.startswith(("plan_aux", "plan_strideT")))
    for k, v in got.items():
        ref = batch[f"plan_{k}"].astype(np.int32)
        assert v.dtype == torch.int32
        np.testing.assert_array_equal(v.numpy(), ref, err_msg=k)
    assert (got["coords3"][..., 0] >= 0).sum(1).min() > 0
    caps = (cfg.voxel.max_voxels,) + tuple(cfg.caps.level_caps[1:])
    cpp = native.build_plans_cpp(batch["coords"][1], cfg.sparse_shape, caps)
    np.testing.assert_array_equal(got["stride3"][1].numpy(), cpp["stride3"])


def test_host_plans_off_builds_none():
    cfg = config.tiny_config(model=dataclasses.replace(
        config.tiny_config().model, host_plans=False))
    _, batch = tiny_scans(4)
    assert kitti.build_host_plans(cfg, batch["coords"][0]) == {}
    assert not any(k.startswith("plan_") for k in synthetic.make_random_batch(
        cfg, np.random.default_rng(0), batch_size=1))


def test_vxnet_device_plans_matches_jax():
    """The port's backbone on its device rulebook == JAX vxnet_apply with
    host_plans=None (dense index maps, sorted levels, dense tail)."""
    cfg, jcfg = config.tiny_config(), jconfig.tiny_config()
    params, state = jax_weights(weights.RELU_GAIN)
    rng = np.random.default_rng(12)
    state = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.normal(0, 0.1, v.shape).astype(np.float32)
                      if p[-1].key == "mean" else
                      rng.uniform(0.5, 1.5, v.shape).astype(np.float32)),
        state)
    _, batch = tiny_scans(5)
    vfe = np.asarray(jbackbone.vfe_mean(jnp.asarray(batch["voxels"]),
                                        jnp.asarray(batch["num_points"])))
    keys = np.stack([np.asarray(jsp.coords_to_keys(
        jnp.asarray(c), cfg.sparse_shape)) for c in batch["coords"]])
    out = jbackbone.vxnet_apply(
        params["vxnet"], state["vxnet"], jnp.asarray(keys), jnp.asarray(vfe),
        sparse_shape=jcfg.sparse_shape, level_caps=jcfg.caps.level_caps,
        train=False, host_plans=None, dense_tail=True, store_im2col=False)
    ref = np.asarray(out[1])                                # [B,D,H,W,C]

    model = weights.from_jax(cfg, params, state, "cpu")
    plans = sp.device_rulebook(torch.from_numpy(keys),
                               model.vxnet.level_shapes,
                               cfg.caps.level_caps[1:])
    feats = vfe_mean(torch.from_numpy(batch["voxels"]),
                     torch.from_numpy(batch["num_points"]))
    got = model.vxnet(feats, plans).detach().numpy()
    assert got.shape == ref.shape
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.fixture(scope="module")
def forward_test_runs():
    """Two tiny scans through a live JAX forward_test with
    host_plans=False, the port's with host_plans=False and the port's on
    host plans, with the same weights: (the port's config, the JAX
    weights, the batch, the anchors, the three detection sets)."""
    cfg, jcfg = config.tiny_config(), jconfig.tiny_config()
    cfg_d = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, host_plans=False))
    jcfg_d = dataclasses.replace(
        jcfg, model=dataclasses.replace(jcfg.model, host_plans=False))
    params, state = jax_weights(weights.RELU_GAIN)
    batch = synthetic.make_random_batch(cfg_d, np.random.default_rng(5),
                                        batch_size=2, n_points=900)
    assert not any(k.startswith("plan_") for k in batch)
    jbatch = jax_random_batch(jcfg_d, np.random.default_rng(5), batch_size=2,
                              n_points=900)
    assert not any(k.startswith("plan_") for k in jbatch)
    anchors = kitti.build_anchors(cfg)[0]
    ref = jdetector.forward_test(params, state,
                                 {k: jnp.asarray(v) for k, v in jbatch.items()},
                                 jnp.asarray(anchors), jcfg_d)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    model = weights.from_jax(cfg_d, params, state, "cpu")
    got = inference.make_test_step(cfg_d, anchors, "cpu")(model, batch)
    got = {k: v.numpy() for k, v in got.items()}
    host_batch = synthetic.make_random_batch(cfg, np.random.default_rng(5),
                                             batch_size=2, n_points=900)
    host = inference.make_test_step(cfg, anchors, "cpu")(
        weights.from_jax(cfg, params, state, "cpu"), host_batch)
    host = {k: v.numpy() for k, v in host.items()}
    return cfg_d, (params, state), batch, anchors, ref, got, host


def test_forward_test_device_plans_matches_jax_and_host_plans(
        forward_test_runs):
    """forward_test with host_plans=False: the port == a live JAX
    forward_test with host_plans=False, and == the port's host-plans
    detections on the same scans, as matched sets."""
    *_, ref, got, host = forward_test_runs
    counts = [matched(got, ref, i) for i in range(2)]
    assert min(counts) >= 3
    for i in range(2):
        matched(got, host, i)
    np.testing.assert_array_equal(got["guided_truncated"],
                                  ref["guided_truncated"])


def test_forward_test_sorted_plans_matches_jax_and_dense(forward_test_runs,
                                                         monkeypatch):
    """forward_test with model.plan_lookup="sorted" (no index map, K18's
    plain version): the port == the live JAX forward_test as matched sets,
    and == the port's dense-map run bit for bit (the same plans, the same
    operations). JAX's own sorted and dense plans are equal
    (tests/test_device_plans.py); its sorted forward_test takes ~50 s to
    trace on the CPU, so its dense run is the reference here, and the
    sorted plans are held to its sorted builders in
    test_torch_sorted_plans.py."""
    cfg_d, (params, state), batch, anchors, ref, dense, _ = forward_test_runs
    cfg_s = dataclasses.replace(cfg_d, model=dataclasses.replace(
        cfg_d.model, plan_lookup="sorted"))
    model = weights.from_jax(cfg_s, params, state, "cpu")

    def no_map(*args):
        raise AssertionError("the sorted path built an index map")
    monkeypatch.setattr(sp, "build_index_map", no_map)
    got = inference.make_test_step(cfg_s, anchors, "cpu")(model, batch)
    got = {k: v.numpy() for k, v in got.items()}
    assert got.keys() == dense.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], dense[k], err_msg=k)
    counts = [matched(got, ref, i) for i in range(2)]
    assert min(counts) >= 3
    np.testing.assert_array_equal(got["guided_truncated"],
                                  ref["guided_truncated"])
