"""Port parity for the inference slice on tiny_config(): the sparse
backbone, the whole forward_test against a live JAX forward_test and
against tests/golden_detections.npz, config and weight conversion, and the
port's import hygiene.

Tolerances: the golden-test ones (tests/test_golden.py) for detections;
1e-4 for backbone features (float32 sums in another order). Random JAX
weights collapse the activations to ~1e-13 (every score ties at 0.5), so
the live comparisons scale every conv weight by the ReLU-preserving gain
sqrt(6) to make the numbers non-trivial.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import sassd_tpu.config as jconfig  # noqa: E402
from sassd_tpu.data.synthetic import make_random_batch as jax_random_batch  # noqa: E402
from sassd_tpu.models import backbone as jbackbone  # noqa: E402
from sassd_tpu.models import detector as jdetector  # noqa: E402
from sassd_tpu.ops.voxelize import VoxelConfig as JVoxelConfig  # noqa: E402
import sassd_tpu_torch.config as config  # noqa: E402
from sassd_tpu_torch import inference, weights  # noqa: E402
from sassd_tpu_torch.data import kitti, synthetic  # noqa: E402
from sassd_tpu_torch.models.backbone import vfe_mean  # noqa: E402
from sassd_tpu_torch.models.detector import Detector  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "golden_detections.npz")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAIN = weights.RELU_GAIN


def jax_weights(gain=1.0, seed=7):
    params, state = jdetector.detector_init(jax.random.PRNGKey(seed),
                                            jconfig.tiny_config())
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: np.asarray(v) * (gain if p[-1].key == "w" else 1.0),
        params)
    return params, jax.tree_util.tree_map(np.asarray, state)


def matched(got, ref, i):
    """Detections of sample i equal as sets within the golden tolerances."""
    gv, rv = got["valid"][i], ref["valid"][i]
    assert gv.sum() == rv.sum()
    gb, gs = got["boxes"][i][gv], got["scores"][i][gv]
    rb, rs = ref["boxes"][i][rv], ref["scores"][i][rv]
    used = np.zeros(len(rb), bool)
    for b, s in zip(gb, gs):
        ok = ((np.abs(rb - b).max(1) <= 1e-2) & (np.abs(rs - s) <= 1e-3)
              & ~used)
        assert ok.any(), (b, s)
        used[np.argmax(ok)] = True
    return int(gv.sum())


def port_dets(model, cfg, batch):
    anchors = kitti.build_anchors(cfg)[0]
    dets = inference.make_test_step(cfg, anchors, "cpu")(model, batch)
    return {k: v.numpy() for k, v in dets.items()}


@pytest.mark.parametrize("name", ["car_config", "tiny_config"])
def test_config_fields_match_jax(name):
    port, ref = getattr(config, name)(), getattr(jconfig, name)()
    for section in ("model", "voxel", "caps", "test", "data", "parallel"):
        p, r = getattr(port, section), getattr(ref, section)
        for f in dataclasses.fields(p):
            assert getattr(p, f.name) == getattr(r, f.name), (section, f.name)
    for cls, p in port.anchors.items():
        for f in dataclasses.fields(p):
            assert getattr(p, f.name) == getattr(ref.anchors[cls], f.name)
    assert port.sparse_shape == ref.sparse_shape
    assert port.num_anchors == ref.num_anchors
    assert port.voxel.sparse_shape == JVoxelConfig(
        **dataclasses.asdict(port.voxel)).sparse_shape


@pytest.mark.parametrize("section,override", [
    ("model", dict(dense_index=False)),
    # "sorted" runs (tests/test_torch_sorted_plans.py); a lookup the JAX
    # package does not have is still refused
    ("model", dict(plan_lookup="hashed")),
    ("model", dict(sorted_device_levels=False)),
    ("model", dict(dense_tail=False)),
    # "bfloat16" runs (ROADMAP A.7); a dtype the JAX package does not have
    # is still refused
    ("model", dict(compute_dtype="float16")),
    # serve_persistent_plans runs; an input mode the JAX package does not
    # have is still refused
    ("test", dict(device_input="range_image")),
    # "spatial" runs (ROADMAP A.3); a strategy the JAX package does not
    # have is still refused
    ("parallel", dict(strategy="pipeline", spatial=2)),
])
def test_unsupported_options_raise(section, override):
    cfg = config.tiny_config()
    cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(
        getattr(cfg, section), **override)})
    with pytest.raises(NotImplementedError):
        Detector(cfg)


def test_import_leaves_jax_out():
    """The port and all its modules (the CLIs of sassd_tpu_torch.tools
    and the JAX checkpoint reader among them) import without JAX,
    sassd_tpu, triton or a CUDA compiler, and build nothing at import."""
    code = (
        "import pkgutil, importlib, sys, sassd_tpu_torch\n"
        "for m in pkgutil.walk_packages(sassd_tpu_torch.__path__,\n"
        "                               'sassd_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from sassd_tpu_torch.ops import cuda, native\n"
        "from sassd_tpu_torch.train import jax_checkpoint\n"
        "from sassd_tpu_torch.tools import (create_data, make_synth_corpus,\n"
        "    import_reference_checkpoint, test, train)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'sassd_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "assert cuda._lib is None and native._lib is None\n")
    env = dict(os.environ, PATH="/usr/bin:/bin")        # no nvcc on PATH
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_weight_round_trip():
    params, state = jax_weights()
    model = weights.from_jax(config.tiny_config(), params, state, "cpu")
    p2, s2 = weights.to_jax(model)
    flat = lambda t: dict(jax.tree_util.tree_leaves_with_path(t))  # noqa: E731
    ref_p = flat({k: params[k] for k in weights.MODULES if k in params})
    ref_s = flat({k: state[k] for k in weights.MODULES if k in state})
    got_p, got_s = flat(p2), flat(s2)
    assert got_p.keys() == ref_p.keys() and got_s.keys() == ref_s.keys()
    for ref, got in ((ref_p, got_p), (ref_s, got_s)):
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])


def test_vxnet_host_plans_dense_tail_matches_jax():
    cfg, jcfg = config.tiny_config(), jconfig.tiny_config()
    params, state = jax_weights(GAIN)
    rng = np.random.default_rng(11)
    state = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.normal(0, 0.1, v.shape).astype(np.float32)
                      if p[-1].key == "mean" else
                      rng.uniform(0.5, 1.5, v.shape).astype(np.float32)),
        state)
    batch = synthetic.make_random_batch(cfg, np.random.default_rng(3),
                                        batch_size=2, n_points=900)
    plans = {k[5:]: v for k, v in batch.items() if k.startswith("plan_")}
    vfe = np.asarray(jbackbone.vfe_mean(jnp.asarray(batch["voxels"]),
                                        jnp.asarray(batch["num_points"])))
    keys = np.stack([np.asarray(jdetector.sp.coords_to_keys(
        jnp.asarray(c), cfg.sparse_shape)) for c in batch["coords"]])
    out = jbackbone.vxnet_apply(
        params["vxnet"], state["vxnet"], jnp.asarray(keys), jnp.asarray(vfe),
        sparse_shape=jcfg.sparse_shape, level_caps=jcfg.caps.level_caps,
        train=False, host_plans={k: jnp.asarray(v) for k, v in plans.items()},
        dense_tail=True, store_im2col=False)
    ref = np.asarray(out[1])                                # [B,D,H,W,C]

    model = weights.from_jax(cfg, params, state, "cpu")
    feats = vfe_mean(torch.from_numpy(batch["voxels"]),
                     torch.from_numpy(batch["num_points"]))
    np.testing.assert_allclose(feats.numpy(), vfe, atol=1e-6)
    got = model.vxnet(feats, {k: torch.from_numpy(v)
                              for k, v in plans.items()}).detach().numpy()
    assert got.shape == ref.shape
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_forward_test_matches_live_jax():
    cfg, jcfg = config.tiny_config(), jconfig.tiny_config()
    params, state = jax_weights(GAIN)
    batch = synthetic.make_random_batch(cfg, np.random.default_rng(5),
                                        batch_size=2, n_points=900)
    jbatch = jax_random_batch(jcfg, np.random.default_rng(5), batch_size=2,
                              n_points=900)
    anchors = jnp.asarray(kitti.build_anchors(cfg)[0])
    jbatch = {k: jnp.asarray(v) for k, v in jbatch.items()}
    ref = jdetector.forward_test(params, state, jbatch, anchors, jcfg)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = port_dets(weights.from_jax(cfg, params, state, "cpu"), cfg, batch)
    counts = [matched(got, ref, i) for i in range(2)]
    assert min(counts) >= 3
    np.testing.assert_array_equal(got["guided_truncated"],
                                  ref["guided_truncated"])


def test_forward_test_matches_golden():
    """tests/golden_detections.npz, produced by the JAX package, within
    tests/test_golden.py's tolerances."""
    cfg = config.tiny_config()
    params, state = jax_weights()
    cfg_t = dataclasses.replace(
        cfg, test=dataclasses.replace(cfg.test, score_thr=0.45))
    model = weights.from_jax(cfg_t, params, state, "cpu")
    batch = synthetic.make_random_batch(cfg, np.random.default_rng(7),
                                        batch_size=2)
    got = port_dets(model, cfg_t, batch)
    ref = np.load(GOLDEN)
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    np.testing.assert_allclose(got["scores"], ref["scores"], atol=1e-3)
    np.testing.assert_allclose(got["boxes"], ref["boxes"], atol=1e-2)
    with torch.no_grad():
        bev = model.forward_spine(inference.to_device(batch, "cpu")).bev_map
    np.testing.assert_allclose(bev.mean(dim=(1, 2)).numpy(), ref["bev_mean"],
                               atol=1e-3)
    np.testing.assert_allclose(float(bev.std()), ref["bev_std"], atol=1e-3)


def test_batch_of_two_equals_two_batches_of_one():
    """Flat-batch plan offsets: sample i of a B=2 run equals its B=1 run."""
    cfg = config.tiny_config()
    params, state = jax_weights(GAIN)
    model = weights.from_jax(cfg, params, state, "cpu")
    batch = synthetic.make_random_batch(cfg, np.random.default_rng(9),
                                        batch_size=2, n_points=900)
    both = port_dets(model, cfg, batch)
    for i in range(2):
        one = port_dets(model, cfg, {k: v[i:i + 1] for k, v in batch.items()})
        matched({k: v[i:i + 1] for k, v in both.items()}, one, 0)


def test_make_random_batch_matches_jax():
    cfg, jcfg = config.tiny_config(), jconfig.tiny_config()
    got = synthetic.make_random_batch(cfg, np.random.default_rng(4))
    ref = jax_random_batch(jcfg, np.random.default_rng(4))
    for k, v in got.items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)


def test_scene_pipeline_matches_jax():
    """make_scene + voxelize + anchors mask + host plans at tiny scale."""
    from sassd_tpu.data.augment import anchors_mask_from_coords
    from sassd_tpu.data.kitti import build_host_plans
    from sassd_tpu.data.synthetic import make_scene
    from sassd_tpu.ops.voxelize import voxelize_np
    cfg, jcfg = config.tiny_config(), jconfig.tiny_config()
    kw = dict(n_cars=(2, 4), n_ground=800, x_range=(1.0, 6.0),
              y_range=(-3.0, 3.0))
    pts, _, _ = synthetic.make_scene(np.random.default_rng(8), **kw)
    jpts, _, _ = make_scene(np.random.default_rng(8), **kw)
    np.testing.assert_array_equal(pts, jpts)
    anchors, anchors_bv = kitti.build_anchors(cfg)
    sample = kitti.prepare_scan(cfg, pts, anchors_bv)
    v, c, n = voxelize_np(jpts, jcfg.voxel, pad=True)
    np.testing.assert_array_equal(sample["voxels"], v)
    np.testing.assert_array_equal(sample["coords"], c)
    np.testing.assert_array_equal(sample["num_points"], n)
    mask = anchors_mask_from_coords(
        c, anchors_bv, jcfg.voxel.voxel_size,
        np.asarray(jcfg.voxel.point_cloud_range), jcfg.voxel.grid_size,
        jcfg.data.anchor_area_threshold)
    np.testing.assert_array_equal(sample["anchors_mask"], mask)
    assert mask.any() and not mask.all()
    for k, arr in build_host_plans(jcfg, c, train=False).items():
        np.testing.assert_array_equal(sample[k], arr, err_msg=k)
