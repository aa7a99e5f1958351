"""Seeded synthetic LiDAR scenes, batches and KITTI-layout datasets (tests
and smoke runs).

The same numpy generator state gives the same points, boxes and files as
the JAX package's ``data/synthetic.py``.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from sassd_tpu_torch.data.augment import corners_2d
from sassd_tpu_torch.data.calib import (Calibration, project_rect_to_image,
                                        project_velo_to_rect)
from sassd_tpu_torch.data.kitti import build_host_plans
from sassd_tpu_torch.ops.voxelize import voxelize_np

_V2C = np.array([[0.0, -1.0, 0.0, 0.0],
                 [0.0, 0.0, -1.0, -0.08],
                 [1.0, 0.0, 0.0, -0.27]], np.float64)
_R0 = np.eye(3)
_P2 = np.array([[721.5, 0.0, 609.6, 44.9],
                [0.0, 721.5, 172.9, 0.2],
                [0.0, 0.0, 1.0, 0.003]], np.float64)
IMAGE_SHAPE = (375, 1242)


def default_calib() -> Calibration:
    return Calibration(P2=_P2, P3=_P2, R0=_R0, V2C=_V2C)


def sample_box_points(box, n, rng):
    """Surface points on a lidar box [x,y,z,w,l,h,yaw], denser at the front."""
    x, y, z, w, l, h, r = box
    local = rng.uniform(-0.49, 0.49, (n, 3)) * [w, l, h]
    axis = rng.integers(0, 3, n)
    sign = rng.choice([-0.49, 0.49], n)
    local[np.arange(n), axis] = sign * np.array([w, l, h])[axis]
    fold = (local[:, 1] < 0) & (rng.uniform(size=n) < 0.7)
    local[fold, 1] = -local[fold, 1]
    c, s = np.cos(r), np.sin(r)
    gx = local[:, 0] * c + local[:, 1] * s + x
    gy = -local[:, 0] * s + local[:, 1] * c + y
    gz = local[:, 2] + z + h / 2
    refl = rng.uniform(0.1, 0.9, n)
    return np.stack([gx, gy, gz, refl], 1).astype(np.float32)


# per-class (size_low, size_high) of synthetic objects, (w, l, h)
_CLASS_SIZES = {
    "Car": ((1.5, 3.4, 1.4), (1.8, 4.4, 1.8)),
    "Pedestrian": ((0.5, 0.6, 1.6), (0.7, 1.0, 1.9)),
    "Cyclist": ((0.5, 1.6, 1.6), (0.7, 1.9, 1.8)),
}


def make_scene(rng, n_cars=(3, 8), n_ground=12000,
               x_range=(4.0, 66.0), y_range=(-36.0, 36.0),
               frustum: bool = False, classes=("Car",)):
    """Returns (points [N,4], boxes [M,7] lidar, types): ground returns
    plus surface points of M objects of the given classes.

    With frustum=True the scene mimics a KITTI velodyne_reduced scan:
    objects stay in the frontal camera frustum and the ground is scan
    lines (48 beam elevations x regular azimuths hitting a flat plane),
    which keeps voxel counts in the real-data regime; otherwise the ground
    is uniform over the KITTI range.
    """
    m = int(rng.integers(*n_cars))
    boxes, types = [], []
    for _ in range(m):
        cls = classes[int(rng.integers(len(classes)))]
        lo, hi = _CLASS_SIZES[cls]
        for _try in range(40):
            b = np.array([
                rng.uniform(*x_range), rng.uniform(*y_range),
                rng.uniform(-1.9, -1.5),
                rng.uniform(lo[0], hi[0]), rng.uniform(lo[1], hi[1]),
                rng.uniform(lo[2], hi[2]), rng.uniform(-np.pi, np.pi)],
                np.float32)
            if frustum and abs(b[1]) > 0.7 * b[0]:
                continue
            if all(np.hypot(b[0] - o[0], b[1] - o[1]) > 5.0 for o in boxes):
                boxes.append(b)
                types.append(cls)
                break
    boxes = np.stack(boxes) if boxes else np.zeros((0, 7), np.float32)

    if frustum:
        n_az = max(int(n_ground) // 48, 64)
        az = np.linspace(-0.70, 0.70, n_az) + rng.normal(0, 1e-3, n_az)
        elev = np.linspace(-0.42, -0.025, 48)
        d = 1.73 / np.tan(-elev)                            # [48]
        d = d[(d > 2.0) & (d < x_range[1] + 6.0)]
        dd, aa = np.meshgrid(d, az)
        dd = dd + rng.normal(0, 0.02, dd.shape)
        gx = (dd * np.cos(aa)).reshape(-1)
        gy = (dd * np.sin(aa)).reshape(-1)
        gz = rng.normal(-1.75, 0.02, gx.shape[0])
        gr = rng.uniform(0, 0.3, gx.shape[0])
    else:
        gx = rng.uniform(0, 70.0, n_ground)
        gy = rng.uniform(-40.0, 40.0, n_ground)
        gz = rng.normal(-1.75, 0.03, n_ground)
        gr = rng.uniform(0, 0.3, n_ground)
    ground = np.stack([gx, gy, gz, gr], 1).astype(np.float32)

    obj_pts = [sample_box_points(b, int(rng.integers(80, 400)), rng)
               for b in boxes]
    points = np.concatenate([ground] + obj_pts, 0) if obj_pts else ground
    rng.shuffle(points, axis=0)
    return points, boxes, types


def long_range_scene(rng, n_cars=(10, 20), n_ground=200000,
                     n_far=35000, classes=("Car",)):
    """A dense scan of the long-range grid (~70,000 voxels, near its
    80,000 cap): a frustum scan (make_scene(frustum=True), objects out to
    101.9 m, scan lines to ~69 m) plus `n_far` ground returns spread
    uniformly over x in [60, 102.4] m, y in [-40, 40] m. Returns (points,
    boxes, types) as make_scene."""
    points, boxes, types = make_scene(
        rng, n_cars=n_cars, n_ground=n_ground, x_range=(2.5, 101.9),
        y_range=(-36.0, 36.0), frustum=True, classes=classes)
    far = np.stack([rng.uniform(60.0, 102.4, n_far),
                    rng.uniform(-40.0, 40.0, n_far),
                    rng.normal(-1.75, 0.03, n_far),
                    rng.uniform(0, 0.3, n_far)], 1).astype(np.float32)
    return np.concatenate([points, far], 0), boxes, types


def lidar_box_to_label_line(box, calib, score=None, name="Car") -> str:
    """Lidar box -> KITTI label line (inverse of the dataset's cam->lidar)."""
    loc = project_velo_to_rect(box[None, :3], calib)[0]
    w, l, h, ry = box[3], box[4], box[5], box[6]
    c2 = corners_2d(box[None, :2], box[None, 3:5], box[None, 6:7][0])[0]
    zs = np.array([box[2], box[2] + h])
    corners = np.array([[cx, cy, z] for (cx, cy) in c2 for z in zs])
    uv = project_rect_to_image(project_velo_to_rect(corners, calib), calib)
    x0, y0 = uv.min(0)
    x1, y1 = uv.max(0)
    alpha = float(-np.arctan2(-box[1], box[0]) + ry)
    fields = [name, "0.00", "0", f"{alpha:.2f}",
              f"{x0:.2f}", f"{y0:.2f}", f"{x1:.2f}", f"{y1:.2f}",
              f"{h:.2f}", f"{w:.2f}", f"{l:.2f}",
              f"{loc[0]:.2f}", f"{loc[1]:.2f}", f"{loc[2]:.2f}", f"{ry:.2f}"]
    if score is not None:
        fields.append(f"{score:.4f}")
    return " ".join(fields)


def make_random_batch(cfg, rng, batch_size: int = 2, n_points: int = 600,
                      n_gt: int = 3):
    """A random batch in the detector's input layout (all anchors enabled,
    the host plans with the train plans, `n_gt` valid GT boxes of class 1).

    Draws the same random stream as the JAX package's make_random_batch,
    GT boxes included, so a seed gives both packages the same voxels.
    """
    plans: dict = {}
    voxels, coords, nums, gts = [], [], [], []
    pcr = np.asarray(cfg.voxel.point_cloud_range)
    for _ in range(batch_size):
        pts = np.zeros((n_points, 4), np.float32)
        pts[:, 0] = rng.uniform(pcr[0], pcr[3], n_points)
        pts[:, 1] = rng.uniform(pcr[1], pcr[4], n_points)
        pts[:, 2] = rng.uniform(pcr[2], pcr[5], n_points)
        pts[:, 3] = rng.uniform(0, 1, n_points)
        v, c, np_ = voxelize_np(pts, cfg.voxel, pad=True)
        voxels.append(v)
        coords.append(c)
        nums.append(np_)
        for k, arr in build_host_plans(cfg, c, train=True).items():
            plans.setdefault(k, []).append(arr)
        g = np.zeros((cfg.caps.max_gt, 7), np.float32)
        g[:n_gt, 0] = rng.uniform(pcr[0] + 1, pcr[3] * 0.8, n_gt)
        g[:n_gt, 1] = rng.uniform(pcr[1] * 0.6, pcr[4] * 0.6, n_gt)
        g[:n_gt, 2] = -1.7
        g[:n_gt, 3:6] = [1.6, 3.9, 1.56]
        g[:n_gt, 6] = rng.uniform(-np.pi, np.pi, n_gt)
        gts.append(g)
    gmask = np.arange(cfg.caps.max_gt) < n_gt
    out = {
        "voxels": np.stack(voxels),
        "num_points": np.stack(nums),
        "coords": np.stack(coords),
        "anchors_mask": np.ones((batch_size, cfg.num_anchors), bool),
        "gt_boxes": np.stack(gts),
        "gt_classes": gmask[None].repeat(batch_size, 0).astype(np.int32),
        "gt_valid": gmask[None].repeat(batch_size, 0),
    }
    out.update({k: np.stack(v) for k, v in plans.items()})
    return out


def write_synthetic_kitti(root: str, n_train: int = 8, n_val: int = 4,
                          seed: int = 0, classes=("Car",),
                          point_cloud_range=None, n_cars=(3, 8),
                          n_ground: int = 16000):
    """Write a synthetic dataset in the KITTI directory layout:

    root/
      training/{velodyne_reduced, label_2, calib}/
      ImageSets/{train.txt, val.txt}

    Scenes are frustum scans (make_scene(frustum=True)). point_cloud_range:
    optional (x0,y0,z0,x1,y1,z1) crop of the consuming config; objects are
    placed inside it, so small configs still see in-range objects.
    """
    if point_cloud_range is not None:
        p = point_cloud_range
        x_range = (max(float(p[0]) + 0.5, 2.5), float(p[3]) - 0.5)
        y_range = (float(p[1]) * 0.9, float(p[4]) * 0.9)
    else:
        x_range, y_range = (4.0, 66.0), (-36.0, 36.0)
    root = Path(root)
    rng = np.random.default_rng(seed)
    calib = default_calib()
    tdir = root / "training"
    for sub in ["velodyne_reduced", "label_2", "calib"]:
        (tdir / sub).mkdir(parents=True, exist_ok=True)
    (root / "ImageSets").mkdir(parents=True, exist_ok=True)

    calib_text = "\n".join([
        "P0: " + " ".join(map(str, _P2.reshape(-1))),
        "P1: " + " ".join(map(str, _P2.reshape(-1))),
        "P2: " + " ".join(map(str, _P2.reshape(-1))),
        "P3: " + " ".join(map(str, _P2.reshape(-1))),
        "R0_rect: " + " ".join(map(str, _R0.reshape(-1))),
        "Tr_velo_to_cam: " + " ".join(map(str, _V2C.reshape(-1))),
        "Tr_imu_to_velo: " + " ".join(map(str, _V2C.reshape(-1))),
    ]) + "\n"

    ids = {"train": [], "val": []}
    for i in range(n_train + n_val):
        split = "train" if i < n_train else "val"
        ids[split].append(i)
        points, boxes, types = make_scene(
            rng, n_cars=n_cars, n_ground=n_ground, x_range=x_range,
            y_range=y_range, frustum=True, classes=classes)
        points.tofile(tdir / "velodyne_reduced" / f"{i:06d}.bin")
        with open(tdir / "calib" / f"{i:06d}.txt", "w") as f:
            f.write(calib_text)
        lines = [lidar_box_to_label_line(b, calib, name=t)
                 for b, t in zip(boxes, types)]
        with open(tdir / "label_2" / f"{i:06d}.txt", "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
    for split, sids in ids.items():
        with open(root / "ImageSets" / f"{split}.txt", "w") as f:
            f.write("\n".join(f"{s:06d}" for s in sids) + "\n")
    return root
