"""Port parity for the device-built rulebook (model.host_plans=False):
index maps and window plans (K6), the sort-based downsample (K7),
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


def test_forward_test_device_plans_matches_jax_and_host_plans():
    """forward_test with host_plans=False: the port == a live JAX
    forward_test with host_plans=False, and == the port's host-plans
    detections on the same scans, as matched sets."""
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
    counts = [matched(got, ref, i) for i in range(2)]
    assert min(counts) >= 3
    for i in range(2):
        matched(got, host, i)
    np.testing.assert_array_equal(got["guided_truncated"],
                                  ref["guided_truncated"])
