"""Port parity for device-resident serving (test.device_input="points"):
the device voxelizer (K8's plain version), the anchors mask (K9's plain
version), prepare_points / PointsView, batch_from_points and the serving
step, each against the JAX package's sassd_tpu/serve.py on the CPU.

Tolerances: voxels, coords, counts, corner cells and masks are copies or
integers and must be equal bit for bit; detections match as sets within
the golden-test tolerances (tests/test_golden.py). The JAX serving graph
gets the port's weights converted from JAX params with every conv weight
scaled by sqrt(6), so scores do not all tie at 0.5.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import sassd_tpu.config as jconfig  # noqa: E402
from sassd_tpu import serve as jserve  # noqa: E402
from sassd_tpu.data.kitti import build_anchors as jbuild_anchors  # noqa: E402
from sassd_tpu.ops.voxelize import voxelize_jax  # noqa: E402
from sassd_tpu_torch import config, inference, serve, weights  # noqa: E402
from sassd_tpu_torch.data import kitti  # noqa: E402
from sassd_tpu_torch.ops import native  # noqa: E402
from sassd_tpu_torch.ops.voxelize import (voxelize, voxelize_np,  # noqa: E402
                                          voxelize_plain)
from test_torch_detector import jax_weights, matched  # noqa: E402


def scene_points(cfg, rng, n=420, boundary=True):
    """Clustered in-range points, strays out of range, one voxel holding
    more than max_num_points points and (boundary=True) points on voxel
    boundaries.

    Jitted JAX divides by the constant voxel size as a reciprocal multiply
    on the CPU, so a boundary point can land one cell off the IEEE divide
    of the host voxelizer, eager JAX and the port (ROADMAP.md section C);
    scans that go through a jitted JAX graph leave boundary points out.
    """
    pcr = np.asarray(cfg.voxel.point_cloud_range)
    centers = np.stack([
        rng.uniform(pcr[0] + 0.5, 0.5 * (pcr[0] + pcr[3]), 4),
        rng.uniform(pcr[1] * 0.6, pcr[4] * 0.6, 4),
        rng.uniform(-1.8, -1.2, 4)], axis=1)
    k = n // 4
    parts = [centers[i] + rng.normal(0, 0.35, (k, 3)) for i in range(4)]
    pts = np.zeros((4 * k, 4), np.float32)
    pts[:, :3] = np.concatenate(parts)
    pts[:, 3] = rng.uniform(0, 1, 4 * k)
    vs = np.asarray(cfg.voxel.voxel_size, np.float32)
    if boundary:
        pts[:20, :2] = np.round(pts[:20, :2] / vs[:2]) * vs[:2]
    pts[20:32, :3] = pts[20, :3]                                # 12 in a voxel
    pts[-5:, 0] = pcr[3] + rng.uniform(0.1, 2.0, 5)             # strays
    pts[-8:-5, 2] = pcr[2] - rng.uniform(0.1, 1.0, 3)
    return pts


def padded(cfg, scans, n_points=None):
    """[B, P, 4] zero-padded scans (no range crop) with garbage past
    n_points, and n_points [B]."""
    p = cfg.caps.max_points_per_scan
    rng = np.random.default_rng(99)
    pts = rng.uniform(0.0, 3.0, (len(scans), p, 4)).astype(np.float32)
    n = np.asarray(n_points or [len(s) for s in scans], np.int32)
    for b, s in enumerate(scans):
        pts[b, :n[b]] = s[:n[b]]
    return pts, n


def uniform_points(cfg, rng, n):
    pcr = np.asarray(cfg.voxel.point_cloud_range)
    pts = np.zeros((n, 4), np.float32)
    for i in range(3):
        pts[:, i] = rng.uniform(pcr[i], pcr[i + 3], n)
    pts[:, 3] = rng.uniform(0, 1, n)
    return pts


@pytest.mark.parametrize("case", ["clustered", "over_cap", "batch"])
def test_voxelize_plain_matches_jax(case):
    """voxelize_plain == voxelize_jax bit for bit: strays, padding past
    n_points, slot overflow, boundary points, and (over_cap) more voxels
    than max_voxels, where the lowest keys win."""
    cfg, jcfg = config.tiny_config(), jconfig.tiny_config()
    rng = np.random.default_rng(0)
    if case == "clustered":
        pts, n = padded(cfg, [scene_points(cfg, rng)])
    elif case == "over_cap":
        pts, n = padded(cfg, [uniform_points(cfg, rng, 1800)])
    else:
        pts, n = padded(cfg, [scene_points(cfg, rng),
                              uniform_points(cfg, rng, 1800)], [400, 1500])
    got = [t.numpy() for t in voxelize(torch.from_numpy(pts),
                                       torch.from_numpy(n), cfg.voxel)]
    for b in range(len(n)):
        valid = jnp.arange(pts.shape[1]) < n[b]
        ref = voxelize_jax(jnp.asarray(pts[b]), valid, jcfg.voxel)
        for g, r, name in zip(got, ref, ("voxels", "coords", "num_points")):
            np.testing.assert_array_equal(g[b], np.asarray(r), err_msg=name)
    n_vox = (got[1][..., 0] >= 0).sum(1)
    if case == "clustered":
        assert got[2].max() == cfg.voxel.max_num_points
        assert 0 < n_vox[0] < cfg.voxel.max_voxels
    else:
        assert n_vox[-1] == cfg.voxel.max_voxels


def corner_table(cfg, anchors_bv):
    return serve.anchor_corner_indices(
        anchors_bv, cfg.voxel.voxel_size, cfg.voxel.point_cloud_range,
        cfg.voxel.grid_size)


@pytest.mark.parametrize("name", ["tiny_config", "car_config"])
def test_anchors_mask_plain_matches_jax(name):
    """anchors_mask_plain == anchors_mask_jax == anchors_mask_jax_separable
    == the C++ host mask, on random voxel sets (no model, so the car grid
    is cheap here); the corner table equals JAX's."""
    cfg, jcfg = getattr(config, name)(), getattr(jconfig, name)()
    _, anchors_bv = kitti.build_anchors(cfg)
    _, janchors_bv = jbuild_anchors(jcfg)
    np.testing.assert_array_equal(anchors_bv, janchors_bv)
    corners = corner_table(cfg, anchors_bv)
    np.testing.assert_array_equal(corners, jserve.anchor_corner_indices(
        anchors_bv, jcfg.voxel.voxel_size, jcfg.voxel.point_cloud_range,
        jcfg.voxel.grid_size))
    d, h, w = cfg.sparse_shape
    cap = cfg.voxel.max_voxels
    rng = np.random.default_rng(1)
    coords = np.full((2, cap, 3), -1, np.int32)
    for b, n in enumerate((cap // 3, cap - 7)):
        # clustered in y so that some anchors pass and some do not
        coords[b, :n, 0] = rng.integers(0, d, n)
        coords[b, :n, 1] = rng.integers(0, h // 2, n)
        coords[b, :n, 2] = rng.integers(0, w, n)
    got = serve.anchors_mask(torch.from_numpy(coords),
                             torch.from_numpy(corners), (h, w),
                             cfg.data.anchor_area_threshold).numpy()
    sep = jserve.separable_corners(anchors_bv, jcfg)
    for b in range(2):
        c = jnp.asarray(coords[b])
        ref = jserve.anchors_mask_jax(c, jnp.asarray(corners), (h, w),
                                      jcfg.data.anchor_area_threshold)
        ref_sep = jserve.anchors_mask_jax_separable(
            c, sep, jcfg.model.num_anchor_per_loc, (h, w),
            jcfg.data.anchor_area_threshold)
        host = native.anchors_mask_cpp(
            coords[b], anchors_bv, cfg.voxel.voxel_size,
            np.asarray(cfg.voxel.point_cloud_range), cfg.voxel.grid_size,
            cfg.data.anchor_area_threshold)
        np.testing.assert_array_equal(got[b], np.asarray(ref))
        np.testing.assert_array_equal(got[b], np.asarray(ref_sep))
        np.testing.assert_array_equal(got[b], host)
        assert got[b].any() and not got[b].all()


def test_integral_image_counts():
    """The integral image's corner is the number of valid voxel rows and a
    cell revisited twice counts twice."""
    coords = torch.tensor([[[0, 1, 2], [1, 1, 2], [0, 0, 0], [-1, -1, -1]]],
                          dtype=torch.int32)
    integral = serve.integral_image_plain(coords, (3, 4))
    assert integral.dtype == torch.float32
    assert float(integral[0, -1, -1]) == 3.0
    assert float(integral[0, 1, 2]) == 3.0 and float(integral[0, 1, 1]) == 1.0


def test_prepare_points_and_points_view_match_jax():
    cfg, jcfg = config.tiny_config(), jconfig.tiny_config()
    rng = np.random.default_rng(2)
    raw = scene_points(cfg, rng)
    for points in (raw, np.concatenate([raw] * 6)):       # under, over cap
        got, n = serve.prepare_points(points, cfg)
        ref, jn = jserve.prepare_points(points, jcfg)
        np.testing.assert_array_equal(got, ref)
        assert n == jn and got.dtype == np.float32
    assert n == cfg.caps.max_points_per_scan

    class Scans:
        def __len__(self):
            return 2

        def load_points(self, idx):
            return scene_points(cfg, np.random.default_rng(idx)), {
                "sample_idx": idx}

    view, jview = serve.PointsView(Scans(), cfg), jserve.PointsView(Scans(),
                                                                   jcfg)
    assert len(view) == 2
    for i in range(2):
        s, r = view[i], jview[i]
        assert s.keys() == r.keys()
        np.testing.assert_array_equal(s["points"], r["points"])
        assert int(s["n_points"]) == int(r["n_points"])
        assert s["meta"] == r["meta"]


@pytest.mark.parametrize("batch_size", [1, 2])
def test_batch_from_points_matches_jax(batch_size):
    """The port's one batched path == JAX batch_from_points at B=1 (its
    unbatched branch) and B=2 (vmap), every output bitwise. JAX runs
    eagerly here: its divide is then IEEE, as in the port."""
    cfg, jcfg = config.tiny_config(), jconfig.tiny_config()
    rng = np.random.default_rng(3 + batch_size)
    scans = [serve.prepare_points(scene_points(cfg, rng, n=300 + 200 * i),
                                  cfg) for i in range(batch_size)]
    pts = np.stack([p for p, _ in scans])
    n = np.asarray([k for _, k in scans], np.int32)
    _, anchors_bv = kitti.build_anchors(cfg)
    corners = corner_table(cfg, anchors_bv)
    got = serve.batch_from_points(torch.from_numpy(pts), torch.from_numpy(n),
                                  torch.from_numpy(corners), cfg)
    ref = jserve.batch_from_points(jnp.asarray(pts), jnp.asarray(n),
                                   jnp.asarray(corners), jcfg)
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    assert not any(k.startswith("plan_") for k in got)


@pytest.fixture(scope="module")
def served():
    """Two scans through the port's serving step and JAX's (one jit), with
    the same sqrt(6)-scaled JAX weights."""
    cfg, jcfg = config.tiny_config(), jconfig.tiny_config()
    params, state = jax_weights(weights.RELU_GAIN)
    anchors, anchors_bv = kitti.build_anchors(cfg)
    rng = np.random.default_rng(5)
    raws = [scene_points(cfg, rng, n=500, boundary=False) for _ in range(2)]
    scans = [serve.prepare_points(r, cfg) for r in raws]
    batch = dict(points=np.stack([p for p, _ in scans]),
                 n_points=np.asarray([k for _, k in scans], np.int32))
    model = weights.from_jax(cfg, params, state, "cpu")
    got = serve.make_serving_step(cfg, anchors, anchors_bv, "cpu")(model,
                                                                   batch)
    jstep = jserve.make_serving_step(jcfg, anchors, anchors_bv)
    ref = jstep(params, state, {k: jnp.asarray(v) for k, v in batch.items()})
    return (cfg, model, anchors, anchors_bv, raws,
            {k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in ref.items()})


def test_serving_step_matches_jax(served):
    *_, got, ref = served
    counts = [matched(got, ref, i) for i in range(2)]
    assert min(counts) >= 3
    np.testing.assert_array_equal(got["guided_truncated"],
                                  ref["guided_truncated"])


def test_serving_step_matches_host_pipeline(served):
    """Points mode == the port's host pipeline (C++ voxelize, mask and
    rulebook in the loader) on under-cap scans."""
    cfg, model, anchors, anchors_bv, raws, got, _ = served
    samples = [kitti.prepare_scan(cfg, r, anchors_bv) for r in raws]
    assert all((s["coords"][:, 0] >= 0).sum() < cfg.voxel.max_voxels
               for s in samples)
    host = inference.make_test_step(cfg, anchors, "cpu")(
        model, kitti.collate(samples)[0])
    host = {k: v.numpy() for k, v in host.items()}
    for i in range(2):
        matched(got, host, i)


def test_points_mode_config_checks():
    cfg = config.tiny_config()
    pts = dataclasses.replace(cfg, test=dataclasses.replace(
        cfg.test, device_input="points"))
    config.check_supported(pts)
    with pytest.raises(NotImplementedError):
        config.check_supported(dataclasses.replace(
            pts, test=dataclasses.replace(pts.test,
                                          serve_persistent_plans=True)))
    assert cfg.class_names == ("Car",) == cfg.data.class_names
    assert config.car_config().caps.max_points_per_scan == 65536


def test_device_voxelizer_quantises_like_host_voxelizer():
    """Below the cap, the device voxelizer's plain version == the C++ host
    voxelizer (first-come slots, key-sorted rows), boundary points
    included: both divide by the voxel size in IEEE float32."""
    cfg = config.tiny_config()
    raw = scene_points(cfg, np.random.default_rng(7))
    pts, n = serve.prepare_points(raw, cfg)
    got = voxelize(torch.from_numpy(pts[None]), torch.from_numpy(
        np.asarray([n], np.int32)), cfg.voxel)
    ref = voxelize_np(raw, cfg.voxel, pad=True)
    assert (ref[1][:, 0] >= 0).sum() < cfg.voxel.max_voxels
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g[0].numpy(), r)


def test_voxelize_plain_is_the_cpu_path():
    cfg = config.tiny_config()
    pts, n = padded(cfg, [scene_points(cfg, np.random.default_rng(6))])
    a = voxelize(torch.from_numpy(pts), torch.from_numpy(n), cfg.voxel)
    b = voxelize_plain(torch.from_numpy(pts), torch.from_numpy(n), cfg.voxel)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
