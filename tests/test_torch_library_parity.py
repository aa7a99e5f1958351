"""Port parity for the library functions no detector path calls: the BEV
and corner box coders, box corners, the BEV point test, the camera <->
lidar transforms, the range anchors and the anchor generators, the image
preprocessing, ConcatDataset, the anchors mask from voxel coords, the C++
point-in-box test, the range crop and the BEV rasters, and the 3-NN over
a candidate plan, each against the JAX package's function on inputs made
from a seed with numpy.

Tolerances: 1e-6 absolute for the coders, the corners and the BEV point
test (float32, the same formula); 1e-5 for corner_box_decode and the
camera <-> lidar transforms; bitwise for the anchors, the image functions,
the range crop, the BEV rasters, ConcatDataset's indexing, the anchors
mask and the C++ point-in-box test; 1e-6 for the 3-NN.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import sassd_tpu.config as jconfig  # noqa: E402
from sassd_tpu.core import anchors as janchors  # noqa: E402
from sassd_tpu.core import boxes as jboxes  # noqa: E402
from sassd_tpu.data import augment as jaugment  # noqa: E402
from sassd_tpu.data import image as jimage  # noqa: E402
from sassd_tpu.data import kitti as jkitti  # noqa: E402
from sassd_tpu.ops import interpolate as jinterp  # noqa: E402
from sassd_tpu.ops import native as jnative  # noqa: E402
from sassd_tpu.ops import voxelize as jvox  # noqa: E402
from sassd_tpu_torch import config  # noqa: E402
from sassd_tpu_torch.core import anchors, boxes  # noqa: E402
from sassd_tpu_torch.data import augment, image, kitti, synthetic  # noqa: E402
from sassd_tpu_torch.ops import interpolate, native, voxelize  # noqa: E402


def rand_boxes(rng, n):
    """[n, 7] boxes: centres within 4 m, sizes 0.5-5 m, any yaw."""
    return np.concatenate([
        rng.uniform(-4, 4, (n, 2)), rng.uniform(-2, 0, (n, 1)),
        rng.uniform(0.5, 5, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1)),
    ], 1).astype(np.float32)


def near_boxes(rng, boxes):
    """Boxes a small pose and size change away (targets of an anchor)."""
    d = np.concatenate([rng.normal(0, 0.3, (len(boxes), 3)),
                        rng.uniform(0.8, 1.25, (len(boxes), 3)),
                        rng.normal(0, 0.3, (len(boxes), 1))], 1)
    out = boxes.copy()
    out[:, :3] += d[:, :3]
    out[:, 3:6] *= d[:, 3:6]
    out[:, 6] += d[:, 6]
    return out.astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=atol)


CODERS = {
    "bev_box_encode": lambda m, b, a: m.bev_box_encode(b, a),
    "second_box_encode": lambda m, b, a: m.second_box_encode(b, a),
    "corner_box_encode": lambda m, b, a: m.corner_box_encode(b, a),
    "corners_3d": lambda m, b, a: m.corners_3d(b),
    "corners_bev": lambda m, b, a: m.corners_bev(b[..., [0, 1, 3, 4, 6]]),
}


@pytest.mark.parametrize("name", sorted(CODERS))
def test_box_geometry_matches_jax(name):
    """Encoders and corners on [2, 64, 7] boxes against JAX, 1e-6."""
    rng = np.random.default_rng(0)
    a = rand_boxes(rng, 128)
    b = near_boxes(rng, a)
    a, b = a.reshape(2, 64, 7), b.reshape(2, 64, 7)
    fn = CODERS[name]
    got = fn(boxes, t(b), t(a)).numpy()
    ref = fn(jboxes, jnp.asarray(b), jnp.asarray(a))
    assert got.shape == ref.shape
    close(got, ref, 1e-6)


@pytest.mark.parametrize("kind", ["bev", "corner"])
def test_box_decoders_match_jax_and_invert(kind):
    """bev_box_decode (1e-6) and corner_box_decode (1e-5) against JAX on
    the encodings of near boxes, and each the inverse of its encoder."""
    rng = np.random.default_rng(1)
    a = rand_boxes(rng, 96)
    b = near_boxes(rng, a)
    # corner decode returns yaw in (-pi, pi]: wrap the targets there
    b[:, 6] = np.arctan2(np.sin(b[:, 6]), np.cos(b[:, 6]))
    enc = getattr(boxes, f"{kind}_box_encode")(t(b), t(a))
    got = getattr(boxes, f"{kind}_box_decode")(enc, t(a)).numpy()
    ref = getattr(jboxes, f"{kind}_box_decode")(jnp.asarray(enc.numpy()),
                                                jnp.asarray(a))
    close(got, ref, 1e-6 if kind == "bev" else 1e-5)
    want = b[:, [0, 1, 3, 4, 6]] if kind == "bev" else b
    close(got, want, 1e-4)


def test_points_in_rbbox_bev_matches_jax():
    rng = np.random.default_rng(2)
    bx = rand_boxes(rng, 24)[:, [0, 1, 3, 4, 6]]
    pts = rng.uniform(-7, 7, (3000, 2)).astype(np.float32)
    got = boxes.points_in_rbbox_bev(t(pts), t(bx)).numpy()
    ref = np.asarray(jboxes.points_in_rbbox_bev(jnp.asarray(pts),
                                                jnp.asarray(bx)))
    assert got.dtype == bool and 0 < got.sum() < got.size
    np.testing.assert_array_equal(got, ref)


def calib_mats():
    """The synthetic calibration's R0_rect and Tr_velo_to_cam as 4 x 4
    homogeneous float32 matrices."""
    c = synthetic.default_calib()
    r_rect, velo2cam = np.eye(4), np.eye(4)
    r_rect[:3, :3] = c.R0
    velo2cam[:3] = c.V2C
    return r_rect.astype(np.float32), velo2cam.astype(np.float32)


@pytest.mark.parametrize("fn", ["box_camera_to_lidar",
                                "camera_to_lidar_points",
                                "lidar_to_camera_points"])
@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_camera_lidar_transforms_match_jax(fn, kind):
    """numpy arrays (the JAX functions' numpy branch) and tensors (against
    their jnp branch), 1e-5; the two transforms invert each other."""
    rng = np.random.default_rng(3)
    r_rect, velo2cam = calib_mats()
    x = (rand_boxes(rng, 50) if fn.startswith("box")
         else rng.uniform(-30, 30, (50, 3)).astype(np.float32))
    if kind == "numpy":
        got = getattr(boxes, fn)(x, r_rect, velo2cam)
        ref = getattr(jboxes, fn)(x, r_rect, velo2cam)
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
    else:
        got = getattr(boxes, fn)(t(x), t(r_rect), t(velo2cam)).numpy()
        ref = getattr(jboxes, fn)(jnp.asarray(x), jnp.asarray(r_rect),
                                  jnp.asarray(velo2cam))
    close(got, ref, 1e-5)
    if fn == "camera_to_lidar_points":
        back = boxes.lidar_to_camera_points(np.asarray(got), r_rect,
                                            velo2cam)
        close(back, x, 1e-4)


ANCHOR_CASES = {
    "stride_car": ("create_anchors_3d_stride", ((1, 20, 22),), {}),
    "stride_two_sizes": ("create_anchors_3d_stride", ((2, 5, 7),), dict(
        sizes=(1.6, 3.9, 1.56, 0.6, 0.8, 1.73), anchor_strides=(0.3, 0.5, 1),
        anchor_offsets=(0.1, -3.0, -1.0), rotations=(0.0, 0.7, 1.57))),
    "range": ("create_anchors_3d_range",
              ((1, 4, 8), (0, -40, -1.78, 70.4, 40, -1.78)), {}),
    "range_3d": ("create_anchors_3d_range",
                 ((3, 5, 6), (-2.5, -7.0, -2.0, 9.0, 7.0, 0.5)),
                 dict(sizes=(0.6, 0.8, 1.73), rotations=(0.3,))),
}


@pytest.mark.parametrize("case", sorted(ANCHOR_CASES))
def test_anchor_grids_match_jax(case):
    fn, args, kw = ANCHOR_CASES[case]
    got = getattr(anchors, fn)(*args, **kw)
    ref = getattr(janchors, fn)(*args, **kw)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("gen", ["stride", "range"])
def test_anchor_generators_match_jax(gen):
    kw = dict(sizes=(1.6, 3.9, 1.56, 0.6, 0.8, 1.73), rotations=(0.0, 1.0))
    if gen == "range":
        kw["anchor_ranges"] = (0.0, -10.0, -1.0, 20.0, 10.0, -1.0)
    name = "AnchorGeneratorStride" if gen == "stride" else \
        "AnchorGeneratorRange"
    port, ref = getattr(anchors, name)(**kw), getattr(janchors, name)(**kw)
    assert (port.num_anchors_per_localization
            == ref.num_anchors_per_localization == 4)
    np.testing.assert_array_equal(port((1, 6, 9)), ref((1, 6, 9)))


def image_case(name):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (23, 37, 3)).astype(np.uint8)
    gray = rng.uniform(0, 1, (16, 9)).astype(np.float32)
    return {
        "rescale_factor": lambda m: m.imrescale(img, 1.7),
        "rescale_bound": lambda m: m.imrescale(img, (60, 20)),
        "rescale_gray": lambda m: m.imrescale(gray, 0.45),
        "normalize": lambda m: m.imnormalize(img, (123.7, 116.3, 103.5),
                                             (58.4, 57.1, 57.4)),
        "pad": lambda m: m.impad_to_multiple(img, 8),
        "transform": lambda m: m.ImageTransform(
            (123.7, 116.3, 103.5), (58.4, 57.1, 57.4), True, 32)(
                img, (80, 50), flip=True),
        "transform_plain": lambda m: m.ImageTransform(to_rgb=False)(
            img, 0.6),
        "bbox_flip": lambda m: m.bbox_flip(
            rng.uniform(0, 30, (5, 4)).astype(np.float32), (23, 37, 3)),
    }[name]


@pytest.mark.parametrize("name", ["rescale_factor", "rescale_bound",
                                  "rescale_gray", "normalize", "pad",
                                  "transform", "transform_plain",
                                  "bbox_flip"])
def test_image_functions_match_jax(name):
    got, ref = image_case(name)(image), image_case(name)(jimage)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        if isinstance(r, np.ndarray):
            assert g.dtype == r.dtype and g.flags.c_contiguous \
                == r.flags.c_contiguous
            np.testing.assert_array_equal(g, r)
        else:
            assert g == r


class Listed:
    """A dataset stand-in: samples and raw points are tagged tuples."""

    def __init__(self, tag, n):
        self.tag, self.n = tag, n
        self.anchors, self.anchors_bv = f"{tag}-anchors", f"{tag}-bv"

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if not 0 <= i < self.n:
            raise IndexError(i)
        return (self.tag, i)

    def load_points(self, i):
        return (self.tag, "points", i)


@pytest.mark.parametrize("sizes", [(3,), (2, 0, 4, 1)])
def test_concat_dataset_indexing_matches_jax(sizes):
    port = kitti.ConcatDataset([Listed(k, n) for k, n in enumerate(sizes)])
    ref = jkitti.ConcatDataset([Listed(k, n) for k, n in enumerate(sizes)])
    assert len(port) == len(ref) == sum(sizes)
    assert (port.anchors, port.anchors_bv) == (ref.anchors, ref.anchors_bv)
    assert [port[i] for i in range(len(port))] == \
        [ref[i] for i in range(len(ref))]
    assert [port.load_points(i) for i in range(len(port))] == \
        [ref.load_points(i) for i in range(len(ref))]


def test_concat_dataset_over_kitti_splits(tmp_path):
    """Two synthetic splits end to end: each index gives its split's raw
    points, as JAX's ConcatDataset over the JAX datasets."""
    cfg, jcfg = config.tiny_config(), jconfig.tiny_config()
    roots = []
    for seed in (1, 2):
        root = tmp_path / f"split{seed}"
        synthetic.write_synthetic_kitti(
            str(root), n_train=0, n_val=2, seed=seed, n_cars=(1, 2),
            n_ground=300, point_cloud_range=cfg.voxel.point_cloud_range)
        roots.append((str(root / "training"),
                      str(root / "ImageSets" / "val.txt")))
    port = kitti.ConcatDataset([kitti.KittiDataset(cfg, *r) for r in roots])
    ref = jkitti.ConcatDataset([jkitti.KittiDataset(jcfg, *r, test_mode=True)
                                for r in roots])
    np.testing.assert_array_equal(port.anchors, ref.anchors)
    for i in range(4):
        (p, pm), (q, qm) = port.load_points(i), ref.load_points(i)
        np.testing.assert_array_equal(p, q)
        assert pm["sample_idx"] == qm["sample_idx"]


def mask_inputs(seed):
    """The tiny grid's anchors and a scan's voxel coords with padding."""
    cfg = config.tiny_config()
    _, bv = kitti.build_anchors(cfg)
    rng = np.random.default_rng(seed)
    pcr = cfg.voxel.point_cloud_range
    pts = synthetic.make_scene(rng, n_cars=(2, 4), n_ground=1500,
                               x_range=(pcr[0] + 1, pcr[3] - 1),
                               y_range=(pcr[1] + 1, pcr[4] - 1))[0]
    coords = kitti.prepare_scan(cfg, pts, bv)["coords"]
    assert (coords[:, 0] < 0).any()
    v = cfg.voxel
    return (coords, bv, v.voxel_size, np.asarray(v.point_cloud_range),
            v.grid_size, cfg.data.anchor_area_threshold)


@pytest.mark.parametrize("seed", [5, 6])
def test_anchors_mask_from_coords_matches_jax(seed, monkeypatch):
    """The C++ mask against JAX's (C++) and the port's plain version
    against JAX's numpy branch, bitwise; all four equal."""
    args = mask_inputs(seed)
    got = augment.anchors_mask_from_coords(*args)
    ref = jaugment.anchors_mask_from_coords(*args)
    plain = augment.anchors_mask_from_coords_plain(*args)
    monkeypatch.setattr(jnative, "available", lambda: False)
    ref_np = jaugment.anchors_mask_from_coords(*args)
    assert got.dtype == bool and 0 < got.sum() < got.size
    for x in (ref, plain, ref_np):
        np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("n_boxes", [0, 1, 17])
def test_points_in_rbbox_cpp_matches_jax(n_boxes):
    rng = np.random.default_rng(7)
    bx = rand_boxes(rng, n_boxes)
    pts = np.concatenate([rng.uniform(-6, 6, (2000, 2)),
                          rng.uniform(-3, 3, (2000, 1)),
                          rng.uniform(0, 1, (2000, 1))], 1).astype(np.float32)
    got = native.points_in_rbbox_cpp(pts, bx)
    ref = jnative.points_in_rbbox_cpp(pts, bx)
    assert got.shape == (2000, n_boxes) and got.dtype == bool
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, augment.points_in_rbbox_np(pts, bx))


def raster_points(seed):
    cfg = config.tiny_config()
    rng = np.random.default_rng(seed)
    lo = np.asarray(cfg.voxel.point_cloud_range[:3]) - 1.0
    hi = np.asarray(cfg.voxel.point_cloud_range[3:]) + 1.0
    pts = np.concatenate([rng.uniform(lo, hi, (4000, 3)),
                          rng.uniform(-0.5, 1.0, (4000, 1))],
                         1).astype(np.float32)
    return cfg.voxel, jconfig.tiny_config().voxel, pts


def test_bound_points_np_matches_jax():
    vc, _, pts = raster_points(8)
    got = voxelize.bound_points_np(pts, vc.point_cloud_range)
    ref = jvox.bound_points_np(pts, vc.point_cloud_range)
    assert 0 < len(got) < len(pts)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("form", ["numpy", "tensor"])
def test_points_to_bev_matches_jax(form):
    """points_to_bev_np against JAX's, and points_to_bev over a valid
    mask against points_to_bev_jax (eager); with every row valid the
    tensor form equals the numpy form."""
    vc, jvc, pts = raster_points(9)
    if form == "numpy":
        got = voxelize.points_to_bev_np(pts, vc)
        ref = jvox.points_to_bev_np(pts, jvc)
        np.testing.assert_array_equal(
            got, voxelize.points_to_bev(t(pts), torch.ones(len(pts), dtype=bool),
                                        vc).numpy())
    else:
        valid = np.random.default_rng(10).uniform(size=len(pts)) < 0.7
        got = voxelize.points_to_bev(t(pts), t(valid), vc).numpy()
        ref = jvox.points_to_bev_jax(jnp.asarray(pts), jnp.asarray(valid),
                                     jvc)
    gx, gy, gz = vc.grid_size
    assert got.shape == (gz + 2, gy, gx) and got[gz + 1].sum() > 0
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_neighborhood_interpolate_matches_jax():
    """[27, N] plans with rows of 27, 3, 2, 1 and 0 found candidates."""
    rng = np.random.default_rng(11)
    m, n, c = 60, 200, 5
    centers = rng.uniform(-2, 2, (m, 3)).astype(np.float32)
    feats = rng.normal(size=(m, c)).astype(np.float32)
    query = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    plan = rng.integers(0, m, (27, n)).astype(np.int32)
    n_found = np.where(np.arange(n) % 5 == 0, 27, np.arange(n) % 5 - 1)
    for q in range(n):
        drop = rng.permutation(27)[:27 - n_found[q]]
        plan[drop, q] = -1
    assert {0, 1, 2, 3, 27} <= set((plan >= 0).sum(0).tolist())
    got = interpolate.neighborhood_interpolate(t(query), t(centers),
                                               t(feats), t(plan)).numpy()
    ref = np.asarray(jinterp.neighborhood_interpolate(
        jnp.asarray(query), jnp.asarray(centers), jnp.asarray(feats),
        jnp.asarray(plan)))
    assert np.all(got[(plan >= 0).sum(0) == 0] == 0)
    close(got, ref, 1e-6)
