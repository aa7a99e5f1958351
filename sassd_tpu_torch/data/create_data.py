"""Offline data preparation for training (host side, numpy): per-split
info files, frustum-cropped scans and the GT database the augmentor
pastes from. The writers of the JAX package's ``data/create_data.py``;
each writes the same files for the same split.

    from sassd_tpu_torch.data import create_data
    create_data.create_reduced_point_cloud(root)           # velodyne_reduced/
    create_data.create_kitti_info_file(root)               # kitti_infos_*.pkl
    create_data.create_groundtruth_database(root, "train")  # gt_database/

``root`` holds ``training/{velodyne[_reduced], calib, label_2}`` and
``ImageSets/{split}.txt``. The database's ``kitti_dbinfos_train.pkl`` is
what ``DataConfig.db_info_path`` names; its point files are relative to
``root``.
"""
from __future__ import annotations

import pickle
from pathlib import Path
from typing import List, Optional

import numpy as np

from . import augment as aug
from . import calib as calib_lib
from .kitti import DEFAULT_IMAGE_SHAPE, png_shape


def _difficulty(obj: calib_lib.Object3d) -> int:
    """KITTI easy (0), moderate (1), hard (2) or none (-1) from the 2D
    box height, occlusion and truncation."""
    height = obj.box2d[3] - obj.box2d[1]
    if height >= 40 and obj.occlusion <= 0 and obj.truncation <= 0.15:
        return 0
    if height >= 25 and obj.occlusion <= 1 and obj.truncation <= 0.3:
        return 1
    if height >= 25 and obj.occlusion <= 2 and obj.truncation <= 0.5:
        return 2
    return -1


def _load_split(root: Path, split: str) -> List[int]:
    with open(root / "ImageSets" / f"{split}.txt") as f:
        return [int(x) for x in f.read().split()]


def create_kitti_info_file(data_root: str, splits=("train", "val"),
                           use_reduced: bool = False):
    """Write kitti_infos_{split}.pkl: per sample its id, image shape,
    calibration and, with a label file, the objects' names, point counts
    and difficulties."""
    root = Path(data_root)
    tdir = root / "training"
    for split in splits:
        infos = []
        for sid in _load_split(root, split):
            calib = calib_lib.Calibration(tdir / "calib" / f"{sid:06d}.txt")
            img = tdir / "image_2" / f"{sid:06d}.png"
            img_shape = png_shape(img) if img.exists() else DEFAULT_IMAGE_SHAPE
            info = dict(sample_idx=sid, img_shape=img_shape,
                        calib=dict(P2=calib.P2, P3=calib.P3, R0=calib.R0,
                                   V2C=calib.V2C))
            label = tdir / "label_2" / f"{sid:06d}.txt"
            if label.exists():
                objs = calib_lib.read_label(label)
                lidar_dir = "velodyne_reduced" if use_reduced else "velodyne"
                pts_path = tdir / lidar_dir / f"{sid:06d}.bin"
                if not pts_path.exists():
                    pts_path = tdir / "velodyne_reduced" / f"{sid:06d}.bin"
                points = calib_lib.read_lidar(pts_path)
                boxes = [o.box3d for o in objs]
                names, nums, diffs = [], [], []
                if boxes:
                    lboxes = np.stack(boxes)
                    lboxes[:, :3] = calib_lib.project_rect_to_velo(
                        lboxes[:, :3], calib)
                    in_box = aug.points_in_rbbox_np(points, lboxes)
                    nums = in_box.sum(0).tolist()
                names = [o.type for o in objs]
                diffs = [_difficulty(o) for o in objs]
                info["annos"] = dict(name=names, num_points_in_gt=nums,
                                     difficulty=diffs)
            infos.append(info)
        out = root / f"kitti_infos_{split}.pkl"
        with open(out, "wb") as f:
            pickle.dump(infos, f)
        print(f"wrote {out} ({len(infos)} samples)")


def create_reduced_point_cloud(data_root: str, splits=("train", "val")):
    """Write each split scan's points inside the camera's image frustum
    (``training/velodyne`` -> ``training/velodyne_reduced``; the image
    size from ``image_2``'s PNG header, else the KITTI default). Scans
    without a ``velodyne`` file are skipped."""
    root = Path(data_root)
    tdir = root / "training"
    out_dir = tdir / "velodyne_reduced"
    out_dir.mkdir(exist_ok=True)
    for split in splits:
        for sid in _load_split(root, split):
            src = tdir / "velodyne" / f"{sid:06d}.bin"
            if not src.exists():
                continue
            points = calib_lib.read_lidar(src)
            calib = calib_lib.Calibration(tdir / "calib" / f"{sid:06d}.txt")
            img = tdir / "image_2" / f"{sid:06d}.png"
            shape = png_shape(img) if img.exists() else DEFAULT_IMAGE_SHAPE
            reduced = calib_lib.remove_outside_points(points, calib, shape)
            reduced.tofile(out_dir / f"{sid:06d}.bin")


def create_groundtruth_database(data_root: str, split: str = "train",
                                classes: Optional[List[str]] = None):
    """Crop every labelled object's points (box-relative) into
    gt_database/{sid}_{type}_{i}.bin and write their infos, by class, to
    kitti_dbinfos_train.pkl. Returns the infos."""
    root = Path(data_root)
    tdir = root / "training"
    db_dir = root / "gt_database"
    db_dir.mkdir(exist_ok=True)
    db_infos: dict = {}
    for sid in _load_split(root, split):
        label = tdir / "label_2" / f"{sid:06d}.txt"
        if not label.exists():
            continue
        objs = [o for o in calib_lib.read_label(label) if o.type != "DontCare"]
        if not objs:
            continue
        calib = calib_lib.Calibration(tdir / "calib" / f"{sid:06d}.txt")
        lidar = tdir / "velodyne_reduced" / f"{sid:06d}.bin"
        if not lidar.exists():
            lidar = tdir / "velodyne" / f"{sid:06d}.bin"
        points = calib_lib.read_lidar(lidar)
        boxes = np.stack([o.box3d for o in objs])
        boxes[:, :3] = calib_lib.project_rect_to_velo(boxes[:, :3], calib)
        in_box = aug.points_in_rbbox_np(points, boxes)
        for i, obj in enumerate(objs):
            if classes is not None and obj.type not in classes:
                continue
            crop = points[in_box[:, i]].copy()
            crop[:, :3] -= boxes[i, :3]
            fname = f"{sid:06d}_{obj.type}_{i}.bin"
            crop.tofile(db_dir / fname)
            db_infos.setdefault(obj.type, []).append(dict(
                name=obj.type, path=f"gt_database/{fname}",
                box3d_lidar=boxes[i].astype(np.float32),
                num_points_in_gt=int(in_box[:, i].sum()),
                difficulty=_difficulty(obj), image_idx=sid, gt_idx=i))
    out = root / "kitti_dbinfos_train.pkl"
    with open(out, "wb") as f:
        pickle.dump(db_infos, f)
    counts = {k: len(v) for k, v in db_infos.items()}
    print(f"wrote {out}: {counts}")
    return db_infos
