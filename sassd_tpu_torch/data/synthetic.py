"""Seeded synthetic LiDAR scenes and batches (tests and smoke runs).

The same numpy generator state gives the same points and boxes as the JAX
package's ``data/synthetic.py``.
"""
from __future__ import annotations

import numpy as np

from sassd_tpu_torch.data.kitti import build_host_plans
from sassd_tpu_torch.ops.voxelize import voxelize_np


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


CAR_SIZES = ((1.5, 3.4, 1.4), (1.8, 4.4, 1.8))     # (w, l, h) low, high


def make_scene(rng, n_cars=(3, 8), n_ground=12000,
               x_range=(4.0, 66.0), y_range=(-36.0, 36.0)):
    """Returns (points [N,4], boxes [M,7] lidar, types): uniform ground
    returns over the KITTI range plus surface points of M cars."""
    m = int(rng.integers(*n_cars))
    boxes, types = [], []
    lo, hi = CAR_SIZES
    for _ in range(m):
        rng.integers(1)       # the JAX generator's class draw (one class)
        for _try in range(40):
            b = np.array([
                rng.uniform(*x_range), rng.uniform(*y_range),
                rng.uniform(-1.9, -1.5),
                rng.uniform(lo[0], hi[0]), rng.uniform(lo[1], hi[1]),
                rng.uniform(lo[2], hi[2]), rng.uniform(-np.pi, np.pi)],
                np.float32)
            if all(np.hypot(b[0] - o[0], b[1] - o[1]) > 5.0 for o in boxes):
                boxes.append(b)
                types.append("Car")
                break
    boxes = np.stack(boxes) if boxes else np.zeros((0, 7), np.float32)

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


def make_random_batch(cfg, rng, batch_size: int = 2, n_points: int = 600,
                      n_gt: int = 3):
    """A random batch in the detector's input layout (all anchors enabled).

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
        for k, arr in build_host_plans(cfg, c).items():
            plans.setdefault(k, []).append(arr)
        g = np.zeros((cfg.caps.max_gt, 7), np.float32)
        g[:n_gt, 0] = rng.uniform(pcr[0] + 1, pcr[3] * 0.8, n_gt)
        g[:n_gt, 1] = rng.uniform(pcr[1] * 0.6, pcr[4] * 0.6, n_gt)
        g[:n_gt, 2] = -1.7
        g[:n_gt, 3:6] = [1.6, 3.9, 1.56]
        g[:n_gt, 6] = rng.uniform(-np.pi, np.pi, n_gt)
        gts.append(g)
    out = {
        "voxels": np.stack(voxels),
        "num_points": np.stack(nums),
        "coords": np.stack(coords),
        "anchors_mask": np.ones((batch_size, cfg.num_anchors), bool),
        "gt_boxes": np.stack(gts),
    }
    out.update({k: np.stack(v) for k, v in plans.items()})
    return out
