"""Port parity for the evaluation runner on the CPU: the synthetic KITTI
writer, calibration and label I/O, the loader, the numpy rotated IoU, the
official KITTI AP protocol, detections -> annotations -> result lines,
and run_inference / evaluate over a synthetic split in both
test.device_input modes, each against the JAX package.

Tolerances: files, annotations, AP dicts and text are equal exactly (the
same numpy code on the same inputs); detections from the two packages or
the two input modes match as sets within the golden-test tolerances
(boxes 1e-2, scores 1e-3).
"""
import dataclasses
import filecmp
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import sassd_tpu.config as jconfig  # noqa: E402
from sassd_tpu import inference as jinference  # noqa: E402
from sassd_tpu.core import riou as jriou  # noqa: E402
from sassd_tpu.data import calib as jcalib  # noqa: E402
from sassd_tpu.data import kitti as jkitti  # noqa: E402
from sassd_tpu.data import loader as jloader  # noqa: E402
from sassd_tpu.data import synthetic as jsynthetic  # noqa: E402
from sassd_tpu.data.augment import anchors_mask_from_coords  # noqa: E402
from sassd_tpu.eval import kitti_eval as jKE  # noqa: E402
from sassd_tpu.eval import results as jresults  # noqa: E402
from sassd_tpu.ops.voxelize import voxelize_np as jvoxelize_np  # noqa: E402
from sassd_tpu_torch import config, inference, serve, weights  # noqa: E402
from sassd_tpu_torch.core import riou_np  # noqa: E402
from sassd_tpu_torch.data import calib, kitti, loader, synthetic  # noqa: E402
from sassd_tpu_torch.eval import kitti_eval as KE  # noqa: E402
from sassd_tpu_torch.eval import results  # noqa: E402
from test_torch_detector import jax_weights  # noqa: E402


def split_config(pkg, device_input="points"):
    """tiny_config() with room for a frustum scan: ~1,250 in-range voxels
    stay under a 2,048 cap, so both input modes see the same voxels."""
    base = pkg.tiny_config()
    return dataclasses.replace(
        base, voxel=dataclasses.replace(base.voxel, max_voxels=2048),
        caps=dataclasses.replace(base.caps, max_points_per_scan=4096,
                                 level_caps=(2048, 2048, 1536, 1024)),
        test=dataclasses.replace(base.test, device_input=device_input))


def tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_write_synthetic_kitti_is_byte_identical(tmp_path):
    kw = dict(n_train=2, n_val=2, seed=3, classes=("Car", "Pedestrian"),
              point_cloud_range=config.tiny_config().voxel.point_cloud_range)
    a, b = tmp_path / "port", tmp_path / "jax"
    synthetic.write_synthetic_kitti(str(a), **kw)
    jsynthetic.write_synthetic_kitti(str(b), **kw)
    files = tree_files(a)
    assert files == tree_files(b) and len(files) == 14
    match, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
    assert not mismatch and not errors


@pytest.mark.parametrize("frustum", [False, True])
def test_make_scene_matches_jax(frustum):
    kw = dict(n_cars=(3, 6), n_ground=3000, frustum=frustum,
              classes=("Car", "Pedestrian", "Cyclist"))
    got = synthetic.make_scene(np.random.default_rng(4), **kw)
    ref = jsynthetic.make_scene(np.random.default_rng(4), **kw)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[2] == ref[2] and len(got[2]) >= 3


def test_calib_label_io_matches_jax(tmp_path):
    synthetic.write_synthetic_kitti(str(tmp_path), n_train=0, n_val=1,
                                    seed=5)
    path = tmp_path / "training" / "calib" / "000000.txt"
    got, ref = calib.Calibration(path), jcalib.Calibration(path)
    for k in ("P2", "P3", "R0", "V2C", "C2V", "velo2cam4", "rect4"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k))
    pts = np.random.default_rng(5).uniform(-20, 20, (50, 3))
    for fn in ("project_velo_to_rect", "project_rect_to_velo",
               "project_rect_to_image"):
        np.testing.assert_array_equal(getattr(calib, fn)(pts, got),
                                      getattr(jcalib, fn)(pts, ref))
    points = calib.read_lidar(tmp_path / "training" / "velodyne_reduced"
                              / "000000.bin")
    np.testing.assert_array_equal(
        calib.remove_outside_points(points, got, (375, 1242)),
        jcalib.remove_outside_points(points, ref, (375, 1242)))
    label = tmp_path / "training" / "label_2" / "000000.txt"
    objs, jobjs = calib.read_label(label), jcalib.read_label(label)
    assert len(objs) == len(jobjs) > 0
    for o, j in zip(objs, jobjs):
        np.testing.assert_array_equal(o.box3d, j.box3d)
        assert (o.type, o.alpha, o.ry, o.score) == (j.type, j.alpha, j.ry,
                                                    j.score)


@pytest.mark.parametrize("shuffle,shards", [(False, 1), (True, 3)])
def test_epoch_indices_match_jax(shuffle, shards):
    for shard in range(shards):
        got = loader.epoch_indices(11, 2, 7, shuffle, shards, shard, 2)
        ref = jloader.epoch_indices(11, 2, 7, shuffle, shards, shard, 2)
        np.testing.assert_array_equal(got, ref)


def test_iterate_batches_order_and_errors():
    """Batches come in index order with their metas, with and without
    worker threads; a sample that raises is raised in the consumer."""
    class Items:
        def __len__(self):
            return 5

        def __getitem__(self, i):
            if i == 3:
                raise KeyError("sample 3")
            return dict(x=np.full((2,), i), meta=dict(sample_idx=i))

    for workers in (0, 2):
        got = []
        with pytest.raises(KeyError):
            for batch, metas in loader.iterate_batches(
                    Items(), 2, shuffle=False, num_workers=workers):
                got.append((batch["x"][:, 0].tolist(),
                            [m["sample_idx"] for m in metas]))
        assert got == [([0, 1], [0, 1])]


@pytest.mark.parametrize("criterion", [-1, 0, 1, 2])
def test_rotate_iou_eval_np_matches_jax(criterion):
    rng = np.random.default_rng(criterion + 5)
    a = np.concatenate([rng.uniform(-5, 5, (30, 2)),
                        rng.uniform(0.5, 4, (30, 2)),
                        rng.uniform(-np.pi, np.pi, (30, 1))], 1)
    b = np.concatenate([a[:10], a[10:20] + 0.3], 0)
    got = riou_np.rotate_iou_eval_np(a, b, criterion)
    ref = jriou.rotate_iou_eval_np(a, b, criterion)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.float32 and (got > 0).sum() > 10
    assert riou_np.rotate_iou_eval_np(a[:0], b).shape == (0, 20)


def make_anno(n, rng, cls="Car", height=60.0):
    """Camera-frame anno with tall, unoccluded boxes."""
    anno = KE.empty_anno()
    x = rng.uniform(-20, 20, n)
    z = rng.uniform(5, 60, n)
    anno.update(
        name=np.array([cls] * n),
        truncated=np.zeros(n), occluded=np.zeros(n, np.int64),
        alpha=rng.uniform(-np.pi, np.pi, n),
        bbox=np.stack([100 + 200 * np.arange(n), np.full(n, 100.0),
                       160 + 200 * np.arange(n), np.full(n, 100.0 + height)],
                      1).astype(np.float64),
        dimensions=np.tile([[3.9, 1.56, 1.6]], (n, 1)),   # (l, h, w)
        location=np.stack([x, np.full(n, 1.65), z], 1),
        rotation_y=rng.uniform(-np.pi, np.pi, n),
        score=rng.uniform(0.3, 1.0, n))
    return anno


def canned_annos(kind, seed=0, n_img=12):
    """(gt, dt) lists: "jittered" = every GT detected with noise;
    "messy" = class mixing (Van, Pedestrian, DontCare), occlusion,
    truncation, short boxes, misses and false positives."""
    rng = np.random.default_rng(seed)
    gts, dts = [], []
    for _ in range(n_img):
        gt = make_anno(5, rng)
        dt = {k: v.copy() for k, v in gt.items()}
        dt["location"] = dt["location"] + rng.normal(0, 0.3, (5, 3))
        dt["score"] = rng.uniform(0, 1, 5)
        if kind == "messy":
            gt["name"] = rng.choice(["Car", "Van", "Pedestrian", "DontCare"],
                                    5, p=[0.55, 0.15, 0.15, 0.15])
            gt["occluded"] = rng.integers(0, 4, 5)
            gt["truncated"] = rng.uniform(0, 0.6, 5)
            gt["bbox"][:, 3] = gt["bbox"][:, 1] + rng.uniform(20, 90, 5)
            keep = rng.random(5) < 0.75
            dt = {k: v[keep] for k, v in dt.items()}
            fp = make_anno(2, rng)
            fp["location"][:, 0] += 300.0
            fp["bbox"] = fp["bbox"] + 4000.0
            dt = {k: np.concatenate([dt[k], fp[k]]) for k in dt}
            dt["name"] = rng.choice(["Car", "Pedestrian"], len(dt["name"]),
                                    p=[0.8, 0.2])
        gts.append(gt)
        dts.append(dt)
    return gts, dts


def assert_same_results(got, ref):
    if isinstance(ref, dict):
        assert got.keys() == ref.keys()
        for k in ref:
            assert_same_results(got[k], ref[k])
    else:
        assert got == ref


@pytest.mark.parametrize("kind", ["jittered", "messy"])
def test_official_eval_result_matches_jax(kind):
    gts, dts = canned_annos(kind)
    classes = ["Car", "Pedestrian"] if kind == "messy" else ["Car"]
    got, text = KE.get_official_eval_result(gts, dts, classes)
    ref, jtext = jKE.get_official_eval_result(gts, dts, classes)
    assert text == jtext
    assert_same_results(got, ref)
    assert 0.0 < got["Car"]["loose"]["3d"]["R40"][1] < 100.0


def test_detections_to_kitti_anno_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    _, boxes, _ = synthetic.make_scene(rng, n_cars=(5, 8))
    boxes = np.concatenate([boxes, [[-30.0, 0, -1.7, 1.6, 3.9, 1.5, 0.3]]])
    meta = dict(calib=synthetic.default_calib(),
                img_shape=synthetic.IMAGE_SHAPE, sample_idx=0)
    args = (boxes, np.linspace(0.9, 0.5, len(boxes)),
            np.zeros(len(boxes), int), np.arange(len(boxes)) != 1)
    got = results.detections_to_kitti_anno(*args, meta, ["Car"])
    ref = jresults.detections_to_kitti_anno(*args, meta, ["Car"])
    assert got.keys() == ref.keys() and len(got["name"]) >= 3
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    lines = results.anno_to_result_lines(got)
    assert lines == jresults.anno_to_result_lines(ref)
    results.write_result_files([got], [7], tmp_path)
    parsed = KE.label_file_to_anno(tmp_path / "000007.txt")
    jparsed = jKE.label_file_to_anno(tmp_path / "000007.txt")
    for k in jparsed:
        np.testing.assert_array_equal(parsed[k], jparsed[k], err_msg=k)
    np.testing.assert_allclose(parsed["location"], got["location"], atol=1e-4)
    empty = results.detections_to_kitti_anno(*args[:3], np.zeros(
        len(boxes), bool), meta, ["Car"])
    assert len(empty["name"]) == 0 and results.anno_to_result_lines(empty) == []


def test_dedup_by_id_and_png_shape(tmp_path):
    annos = [dict(i=i) for i in range(5)]
    a, ids = inference._dedup_by_id(annos, [3, 1, 3, 2, 1])
    assert ids == [1, 2, 3] and [x["i"] for x in a] == [1, 3, 0]
    png = tmp_path / "x.png"
    png.write_bytes(b"\x89PNG\r\n\x1a\n" + b"\0\0\0\rIHDR"
                    + (1242).to_bytes(4, "big") + (375).to_bytes(4, "big"))
    assert kitti.png_shape(png) == jkitti.png_shape(png) == (375, 1242)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """A 2-scan synthetic val split and the seeded-weights detections of
    both packages: JAX points mode (one jit), port points and voxels mode."""
    root = tmp_path_factory.mktemp("kitti")
    cfg = split_config(config)
    jcfg = split_config(jconfig)
    synthetic.write_synthetic_kitti(
        str(root), n_train=0, n_val=2, seed=1, n_cars=(2, 4),
        n_ground=3000, point_cloud_range=cfg.voxel.point_cloud_range)
    data_root, split_file = root / "training", root / "ImageSets" / "val.txt"
    params, state = jax_weights(weights.RELU_GAIN)
    jds = jkitti.KittiDataset(jcfg, str(data_root), str(split_file),
                              test_mode=True)
    ref = jinference.run_inference(jcfg, jds, params, state, batch_size=2)
    ds = kitti.KittiDataset(cfg, str(data_root), str(split_file))
    model = weights.from_jax(cfg, params, state)
    got = inference.run_inference(cfg, ds, model, batch_size=2)
    cfg_v = split_config(config, "voxels")
    vox = inference.run_inference(cfg_v, ds, model, batch_size=1)
    return cfg, ds, data_root, got, ref, vox


def matched_annos(a, b):
    """Two KITTI annos of one scan equal as sets: boxes and locations to
    1e-2, scores to 1e-3."""
    assert len(a["name"]) == len(b["name"])
    used = np.zeros(len(b["name"]), bool)
    for i in range(len(a["name"])):
        ok = ((np.abs(b["location"] - a["location"][i]).max(1) <= 1e-2)
              & (np.abs(b["dimensions"] - a["dimensions"][i]).max(1) <= 1e-2)
              & (np.abs(b["score"] - a["score"][i]) <= 1e-3) & ~used)
        assert ok.any(), (a["location"][i], a["score"][i])
        used[np.argmax(ok)] = True
    return len(a["name"])


def test_run_inference_points_matches_jax(split):
    cfg, ds, _, got, ref, _ = split
    assert got[1] == ref[1] == [0, 1]
    for s in range(2):
        assert (ds[s]["coords"][:, 0] >= 0).sum() < cfg.voxel.max_voxels
        n = int(serve.PointsView(ds, cfg)[s]["n_points"])
        assert n < cfg.caps.max_points_per_scan    # no point cut by the cap
    counts = [matched_annos(a, b) for a, b in zip(got[0], ref[0])]
    assert min(counts) >= 1


def test_run_inference_points_matches_voxels_mode(split):
    _, _, _, got, _, vox = split
    assert vox[1] == got[1]
    for a, b in zip(got[0], vox[0]):
        matched_annos(a, b)


def test_evaluate_matches_jax(split, tmp_path):
    """The port's evaluate == JAX evaluate on the same annotations: the
    same AP dict and table; result files round-trip through the label
    reader."""
    cfg, ds, data_root, got, _, _ = split
    label_dir = str(data_root / "label_2")
    res, text = inference.evaluate(cfg, ds, None, label_dir,
                                   precomputed=got)
    jres, jtext = jinference.evaluate(split_config(jconfig), None, None,
                                      None, label_dir, precomputed=got)
    assert text == jtext and "Car AP@0.70, 0.70, 0.70:" in text
    assert_same_results(res, jres)
    results.write_result_files(*got, tmp_path)
    back = KE.get_label_annos(tmp_path, got[1])
    for a, b in zip(back, got[0]):
        np.testing.assert_allclose(a["location"], b["location"], atol=1e-4)
        np.testing.assert_allclose(a["score"], b["score"], atol=1e-6)


def test_raw_scan_dataset_matches_jax(split):
    """load_points == JAX's; a sample == JAX's host voxelizer and mask
    (JAX's own RawScanDataset.__getitem__ raises, ROADMAP.md section C)."""
    cfg, _, data_root, *_ = split
    jcfg = split_config(jconfig)
    scans = str(data_root / "velodyne_reduced")
    ds = kitti.RawScanDataset(cfg, scans)
    jds = jkitti.RawScanDataset(jcfg, scans)
    assert len(ds) == len(jds) == 2
    p, meta = ds.load_points(1)
    jp, jmeta = jds.load_points(1)
    np.testing.assert_array_equal(p, jp)
    assert meta["sample_idx"] == 1 and meta["img_shape"] == jmeta["img_shape"]
    np.testing.assert_array_equal(meta["calib"].P2, jmeta["calib"].P2)
    s = ds[1]
    v, c, n = jvoxelize_np(jp, jcfg.voxel, pad=True)
    mask = anchors_mask_from_coords(
        c, jds.anchors_bv, jcfg.voxel.voxel_size,
        np.asarray(jcfg.voxel.point_cloud_range), jcfg.voxel.grid_size,
        jcfg.data.anchor_area_threshold)
    for k, r in zip(("voxels", "coords", "num_points", "anchors_mask"),
                    (v, c, n, mask)):
        np.testing.assert_array_equal(s[k], r, err_msg=k)
    assert s["meta"]["sample_idx"] == 1
