"""Port parity of the training augmentation: the GT-database sampler and
PointAugmentor's five steps against the JAX package's with the same seed,
the port's create_data against the JAX package's on one three-class
synthetic split, KittiDataset(train=True) samples with the augmentor
against the JAX package's prepare_train, and train_model on such a split
with device plans. Everything here is host numpy and must be bitwise
equal.
"""
import dataclasses
import pickle
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import sassd_tpu.config as jconfig  # noqa: E402
from sassd_tpu.data import augment as jaug  # noqa: E402
from sassd_tpu.data import create_data as jcreate  # noqa: E402
from sassd_tpu.data import kitti as jkitti  # noqa: E402
from sassd_tpu_torch import config  # noqa: E402
from sassd_tpu_torch.data import augment as aug  # noqa: E402
from sassd_tpu_torch.data import create_data, kitti, synthetic  # noqa: E402
from sassd_tpu_torch.train import loop  # noqa: E402
from test_torch_train_device_plans import CLASSES, three_class  # noqa: E402


def scene_db(seed, n=12):
    """An in-memory GT database of the three classes (box-relative points)
    and a scene's GT boxes, types and points."""
    rng = np.random.default_rng(seed)
    db = {}
    for i in range(n):
        points, boxes, types = synthetic.make_scene(
            rng, n_cars=(2, 4), n_ground=300, classes=CLASSES)
        for b, t in zip(boxes, types):
            pts = synthetic.sample_box_points(b, int(rng.integers(3, 60)),
                                              rng)
            pts[:, :3] -= b[:3]
            db.setdefault(t, []).append(dict(
                name=t, points=pts, box3d_lidar=b.astype(np.float32),
                num_points_in_gt=len(pts),
                difficulty=int(rng.integers(-1, 3))))
    points, boxes, types = synthetic.make_scene(rng, n_cars=(3, 6),
                                                n_ground=4000,
                                                classes=CLASSES)
    return db, boxes, types, points


def test_point_augmentor_matches_jax():
    """sample_all, noise_per_object, random_flip, global_rotation and
    global_scaling, applied in the dataset's order, twice in a row (the
    samplers' pools carry over): every output bitwise equal."""
    db, boxes, types, points = scene_db(0)
    kw = dict(root_path="", info_path="", sample_classes=CLASSES,
              min_num_points=[5, 5, 5], sample_max_num=[15, 10, 10],
              removed_difficulties=[-1], db_infos=db)
    outs = []
    for mod in (aug, jaug):
        a = mod.PointAugmentor(rng=np.random.default_rng(3), **kw)
        got = []
        for _ in range(2):
            s_boxes, s_types, s_points = a.sample_all(boxes.copy(),
                                                      list(types))
            masks = mod.points_in_rbbox_np(points, s_boxes)
            pts = np.concatenate([s_points, points[~masks.any(-1)]], 0)
            gtb = np.concatenate([boxes, s_boxes])
            got += [s_boxes, np.array(s_types), s_points]
            gtb, pts = a.noise_per_object(gtb, pts)
            got += [gtb.copy(), pts.copy()]
            for step in (lambda g, p: a.random_flip(g, p, 0.5),
                         a.global_rotation, a.global_scaling):
                gtb, pts = step(gtb, pts)
                got += [gtb.copy(), pts.copy()]
        outs.append(got)
    assert len(outs[0][0]) > 0                       # objects were pasted
    for i, (p, j) in enumerate(zip(*outs)):
        assert p.dtype == j.dtype, i
        np.testing.assert_array_equal(p, j, err_msg=str(i))


def test_geometry_matches_jax():
    rng = np.random.default_rng(1)
    b = np.zeros((40, 7), np.float32)
    b[:, :2] = rng.uniform(-10, 10, (40, 2))
    b[:, 2] = -1.7
    b[:, 3:6] = rng.uniform(0.5, 4.5, (40, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, 40)
    c = aug.corners_2d(b[:, :2], b[:, 3:5], b[:, 6])
    np.testing.assert_array_equal(
        aug.box_collision_test(c, c),
        jaug.box_collision_test(c, c))
    pts = rng.uniform([-10, -10, -2.5], [10, 10, 1.0], (3000, 3))
    np.testing.assert_array_equal(aug.points_in_rbbox_np(pts, b),
                                  jaug.points_in_rbbox_np(pts, b))
    np.testing.assert_array_equal(aug.rotate_points_z(pts, 0.3),
                                  jaug.rotate_points_z(pts, 0.3))


def tiny_split(root, n_train=4, seed=1):
    cfg = config.tiny_config()
    synthetic.write_synthetic_kitti(
        str(root), n_train=n_train, n_val=0, seed=seed, classes=CLASSES,
        point_cloud_range=cfg.voxel.point_cloud_range, n_cars=(2, 4),
        n_ground=1200)
    return root


def test_create_data_matches_jax(tmp_path):
    """Info files, the GT database's infos and every point file of a
    three-class split equal the JAX package's on a copy of the split."""
    ours = tiny_split(tmp_path / "ours")
    theirs = tmp_path / "theirs"
    shutil.copytree(ours, theirs)
    create_data.create_kitti_info_file(str(ours), splits=("train",))
    infos = create_data.create_groundtruth_database(str(ours), "train",
                                                    list(CLASSES))
    jcreate.create_kitti_info_file(str(theirs), splits=("train",))
    jinfos = jcreate.create_groundtruth_database(str(theirs), "train",
                                                 list(CLASSES))
    assert set(infos) == set(CLASSES) and set(jinfos) == set(infos)

    def same(a, b, where):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), where
            for k in a:
                same(a[k], b[k], f"{where}.{k}")
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b), where
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{where}[{i}]")
        else:
            np.testing.assert_array_equal(a, b, err_msg=where)
    for name in ("kitti_infos_train.pkl", "kitti_dbinfos_train.pkl"):
        with open(ours / name, "rb") as f, open(theirs / name, "rb") as g:
            same(pickle.load(f), pickle.load(g), name)
    files = sorted(p.name for p in (ours / "gt_database").iterdir())
    assert files == sorted(p.name for p in (theirs / "gt_database").iterdir())
    assert len(files) == sum(len(v) for v in infos.values())
    for name in files:
        assert ((ours / "gt_database" / name).read_bytes()
                == (theirs / "gt_database" / name).read_bytes()), name


def augmented_config(mod, root, aux="ring"):
    """The three-class tiny config with the split's GT database and
    sample counts the tiny range can hold."""
    cfg = three_class(mod, aux)
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, db_info_path=str(root / "kitti_dbinfos_train.pkl"),
        sample_classes=CLASSES, sample_max_num=(4, 3, 3),
        min_num_points=(5, 5, 5), num_workers=0))


@pytest.fixture(scope="module")
def augmented_split(tmp_path_factory):
    root = tiny_split(tmp_path_factory.mktemp("kitti"), n_train=4)
    create_data.create_groundtruth_database(str(root), "train",
                                            list(CLASSES))
    return root


def test_kitti_train_samples_match_jax(augmented_split):
    """Three passes over the split with the augmentor: every sample's
    voxels, coords, counts, anchors mask and GT boxes, classes and
    validity are bitwise JAX's prepare_train's."""
    root = augmented_split
    split = str(root / "ImageSets" / "train.txt")
    ds = kitti.KittiDataset(augmented_config(config, root),
                            str(root / "training"), split, train=True)
    jds = jkitti.KittiDataset(augmented_config(jconfig, root),
                              str(root / "training"), split)
    assert ds.augmentor is not None and jds.augmentor is not None
    n_pasted = 0
    for i in list(range(len(ds))) * 3:
        got, ref = ds[i], jds[i]
        assert got["meta"]["sample_idx"] == ref["meta"]["sample_idx"]
        assert not any(k.startswith("plan_") for k in got)
        for k in ("voxels", "num_points", "coords", "anchors_mask",
                  "gt_boxes", "gt_classes", "gt_valid"):
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        n_pasted += int(got["gt_valid"].sum())
    labels = ref["gt_classes"][ref["gt_valid"]]
    assert n_pasted > 3 * len(ds) and labels.min() >= 1 and labels.max() <= 3


def test_augmented_samples_keep_level0_sorted(augmented_split):
    """The loader's level 0 with GT sampling (objects pasted from the
    database before the C++ voxelizer) ascends in key order, as
    model.plan_lookup="sorted" assumes, and the sorted train rulebook of
    a batch of them is the dense one."""
    from sassd_tpu_torch.models.backbone import level_shapes
    from sassd_tpu_torch.ops import sparse as sp
    root = augmented_split
    cfg = augmented_config(config, root)
    ds = kitti.KittiDataset(cfg, str(root / "training"),
                            str(root / "ImageSets" / "train.txt"),
                            train=True)
    assert ds.augmentor is not None
    coords = np.stack([ds[i]["coords"] for i in range(len(ds))])
    keys = sp.coords_to_keys(torch.from_numpy(coords), cfg.sparse_shape)
    k = keys.to(torch.int64)
    valid = keys != sp.INVALID_KEY
    assert (valid[:, 1:] <= valid[:, :-1]).all()
    assert ((k[:, 1:] - k[:, :-1])[valid[:, 1:]] > 0).all()
    assert int(valid.sum(1).min()) > 50
    shapes = level_shapes(cfg.sparse_shape)
    caps = cfg.caps.level_caps[1:]
    dense = sp.device_rulebook(keys, shapes, caps, train=True)
    got = sp.device_rulebook(keys, shapes, caps, train=True,
                             plan_lookup="sorted")
    assert list(got) == list(dense)
    for name, v in dense.items():
        assert torch.equal(got[name], v), name


@pytest.mark.parametrize("aux", ["ring", "exact"])
def test_train_model_three_class_device_plans(tmp_path, monkeypatch,
                                              augmented_split, aux):
    """train_model on the augmented three-class split with device plans:
    finite losses, no skipped update, a checkpoint a second call resumes
    from."""
    cfg = augmented_config(config, augmented_split, aux)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, log_interval=1, checkpoint_interval=1))
    config.check_supported(cfg, train=True)
    ds = kitti.KittiDataset(
        cfg, str(augmented_split / "training"),
        str(augmented_split / "ImageSets" / "train.txt"), train=True)
    metrics = []
    step_fn = loop.make_train_step

    def recording(*args, **kwargs):
        step = step_fn(*args, **kwargs)

        def run(model, batch):
            m = step(model, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            return m
        return run
    monkeypatch.setattr(loop, "make_train_step", recording)
    _, opt, step = loop.train_model(cfg, ds, str(tmp_path / "work"),
                                    total_epochs=1, device="cpu")
    monkeypatch.undo()
    assert step == 2 and opt.count == 2 and len(metrics) == 2
    for m in metrics:
        assert all(np.isfinite(v) for v in m.values()), m
        assert m["nonfinite_skips"] == 0.0 and m["loss"] > 0
    _, opt2, step2 = loop.train_model(cfg, ds, str(tmp_path / "work"),
                                      total_epochs=1, device="cpu")
    assert step2 == 2 and opt2.count == 2
