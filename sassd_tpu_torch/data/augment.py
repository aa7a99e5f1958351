"""Point-cloud geometry and training augmentation (host side, numpy): a
copy of the JAX package's ``data/augment.py``.

* BEV corners (result files, the GT range filter), nearest axis-aligned
  BEV boxes and the anchors mask, rotated point-in-box tests;
* the GT-database sampler with BEV collision rejection
  (:meth:`PointAugmentor.sample_all`), per-object pose noise with
  collision-checked retries, and the global flip, rotation and scaling.

Every random draw comes from one ``np.random.Generator`` in the JAX
package's order, so a seed gives both packages the same samples. Yaw is
clockwise-positive.
"""
from __future__ import annotations

import pickle
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from sassd_tpu_torch.ops import native


def rotate_points_z(points: np.ndarray, angle: float) -> np.ndarray:
    """Rotate [N, >=2] xy(z...) points clockwise by `angle` around +z."""
    c, s = np.cos(angle), np.sin(angle)
    out = points.copy()
    out[:, 0] = points[:, 0] * c + points[:, 1] * s
    out[:, 1] = -points[:, 0] * s + points[:, 1] * c
    return out


def corners_2d(centers: np.ndarray, dims: np.ndarray,
               angles: Optional[np.ndarray] = None) -> np.ndarray:
    """[N,2] centers + [N,2] dims (+ yaw) -> [N, 4, 2] corners (clockwise yaw)."""
    sx = np.array([0.5, -0.5, -0.5, 0.5])[None, :] * dims[:, 0:1]
    sy = np.array([0.5, 0.5, -0.5, -0.5])[None, :] * dims[:, 1:2]
    if angles is not None:
        c, s = np.cos(angles)[:, None], np.sin(angles)[:, None]
        x = sx * c + sy * s
        y = -sx * s + sy * c
    else:
        x, y = sx, sy
    return np.stack([x + centers[:, 0:1], y + centers[:, 1:2]], axis=-1)


def box_collision_test(corners1: np.ndarray,
                       corners2: np.ndarray) -> np.ndarray:
    """Pairwise collision of convex BEV rectangles (separating axes):
    [N,4,2] x [M,4,2] -> [N,M] bool. Pairs whose axis-aligned bounds are
    disjoint cannot collide and skip the axis test."""
    n, m = corners1.shape[0], corners2.shape[0]
    out = np.zeros((n, m), bool)
    if n == 0 or m == 0:
        return out
    min1, max1 = corners1.min(axis=1), corners1.max(axis=1)   # [N, 2]
    min2, max2 = corners2.min(axis=1), corners2.max(axis=1)   # [M, 2]
    near = ~np.any((max1[:, None] < min2[None] - 1e-9)
                   | (max2[None] < min1[:, None] - 1e-9), axis=-1)
    i, j = np.nonzero(near)
    if i.size:
        out[i, j] = _sat_collide_pairs(corners1[i], corners2[j])
    return out


def _sat_collide_pairs(c1: np.ndarray, c2: np.ndarray) -> np.ndarray:
    """Collision of matched rectangle pairs: [P,4,2] x [P,4,2] -> [P]
    bool, on the normalised edge normals of both."""
    if c1.shape[0] == 0:
        return np.zeros((0,), bool)
    e = np.concatenate([np.roll(c1, -1, 1) - c1, np.roll(c2, -1, 1) - c2], 1)
    ax = np.stack([-e[..., 1], e[..., 0]], axis=-1)            # [P,8,2]
    ax = ax / np.maximum(np.linalg.norm(ax, axis=-1, keepdims=True), 1e-9)
    p1 = np.einsum("pka,pqa->pkq", ax, c1)                     # [P,8,4]
    p2 = np.einsum("pka,pqa->pkq", ax, c2)
    sep = (p1.max(-1) < p2.min(-1) - 1e-9) | (p2.max(-1) < p1.min(-1) - 1e-9)
    return ~sep.any(-1)


def points_in_rbbox_np(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """[N,>=3] points vs [M,7] lidar boxes (z bottom) -> [N,M] bool. A
    box's bounding circle prefilters its candidates (an exact superset:
    every point inside lies within the half diagonal of the centre)."""
    n, m = points.shape[0], boxes.shape[0]
    out = np.zeros((n, m), bool)
    if m == 0 or n == 0:
        return out
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    for j in range(m):
        bx, by, bz, bl, bw, bh, yaw = boxes[j, :7]
        r = 0.5 * np.hypot(bl, bw)
        dx = x - bx
        dy = y - by
        cand = ((np.abs(dx) <= r) & (np.abs(dy) <= r)
                & (z >= bz) & (z <= bz + bh))
        idx = np.nonzero(cand)[0]
        if idx.size == 0:
            continue
        c, s = np.cos(yaw), np.sin(yaw)
        lx = dx[idx] * c - dy[idx] * s
        ly = dx[idx] * s + dy[idx] * c
        out[idx, j] = (np.abs(lx) <= bl / 2) & (np.abs(ly) <= bw / 2)
    return out


def nearest_bev_np(boxes: np.ndarray) -> np.ndarray:
    """[A,7] -> [A,4] nearest axis-aligned BEV box (xmin, ymin, xmax, ymax)."""
    rots = boxes[:, 6] - np.floor(boxes[:, 6] / np.pi + 0.5) * np.pi
    cond = np.abs(rots) > np.pi / 4
    dx = np.where(cond, boxes[:, 4], boxes[:, 3])
    dy = np.where(cond, boxes[:, 3], boxes[:, 4])
    return np.stack([boxes[:, 0] - dx / 2, boxes[:, 1] - dy / 2,
                     boxes[:, 0] + dx / 2, boxes[:, 1] + dy / 2], axis=1)


def filter_gt_box_outside_range(gt_boxes: np.ndarray,
                                bv_range: Sequence[float]) -> np.ndarray:
    """[N] bool: boxes with at least one BEV corner inside [xmin, ymin,
    xmax, ymax]."""
    if gt_boxes.shape[0] == 0:
        return np.zeros((0,), bool)
    corners = corners_2d(gt_boxes[:, :2], gt_boxes[:, 3:5], gt_boxes[:, 6])
    inside = ((corners[..., 0] >= bv_range[0])
              & (corners[..., 0] <= bv_range[2])
              & (corners[..., 1] >= bv_range[1])
              & (corners[..., 1] <= bv_range[3]))
    return np.any(inside, axis=1)


def anchors_mask_from_coords(coords_zyx: np.ndarray, anchors_bv: np.ndarray,
                             voxel_size, pc_range, grid_size,
                             threshold: float) -> np.ndarray:
    """[A] bool: anchors whose nearest-BEV footprint [A, 4] covers more
    than `threshold` occupied BEV cells of the scan's voxels [V, 3] zyx
    (rows < 0 are padding), by an integral image; the C++ host library's
    routine. voxel_size / pc_range / grid_size are xyz."""
    return native.anchors_mask_cpp(coords_zyx, anchors_bv, voxel_size,
                                   np.asarray(pc_range), grid_size,
                                   threshold)


def anchors_mask_from_coords_plain(coords_zyx: np.ndarray,
                                   anchors_bv: np.ndarray, voxel_size,
                                   pc_range, grid_size,
                                   threshold: float) -> np.ndarray:
    """numpy version of anchors_mask_from_coords (for tests)."""
    h, w = int(grid_size[1]), int(grid_size[0])
    ok = coords_zyx[:, 0] >= 0
    dense = np.zeros((h, w), np.float32)
    np.add.at(dense, (coords_zyx[ok, 1], coords_zyx[ok, 2]), 1.0)
    integral = dense.cumsum(0).cumsum(1)
    # float32 like the C++ routine: anchor edges land exactly on grid
    # lines, where a float64 floor can land one cell lower
    bv = anchors_bv.astype(np.float32)
    pcr = np.asarray(pc_range, np.float32)
    vs = np.asarray(voxel_size, np.float32)

    def cell(v, axis, n):
        return np.clip(np.floor((v - pcr[axis]) / vs[axis]).astype(np.int64),
                       0, n - 1)
    x0, y0 = cell(bv[:, 0], 0, w), cell(bv[:, 1], 1, h)
    x1, y1 = cell(bv[:, 2], 0, w), cell(bv[:, 3], 1, h)
    area = (integral[y1, x1] - integral[y0, x1]
            - integral[y1, x0] + integral[y0, x0])
    return area > threshold


class BatchSampler:
    """Draws from a pool in a shuffled order, reshuffling when a draw
    would run past its end."""

    def __init__(self, sampled_list, shuffle=True, rng=None):
        self._list = sampled_list
        self._rng = rng or np.random.default_rng()
        self._indices = np.arange(len(sampled_list))
        self._shuffle = shuffle
        if shuffle:
            self._rng.shuffle(self._indices)
        self._idx = 0

    def sample(self, num: int) -> List:
        if self._idx + num >= len(self._list):
            ret = self._indices[self._idx:].copy()
            if self._shuffle:
                self._rng.shuffle(self._indices)
            self._idx = 0
        else:
            ret = self._indices[self._idx: self._idx + num]
            self._idx += num
        return [self._list[i] for i in ret]


class PointAugmentor:
    """The training augmentation: GT-database paste, per-object noise,
    global flip, rotation and scaling.

    db_infos (or the pickle at info_path, written by
    data.create_data.create_groundtruth_database) maps a class name to its
    database objects: dicts with name, path (relative to root_path) or
    points, box3d_lidar, num_points_in_gt and difficulty.
    """

    def __init__(self, root_path, info_path, sample_classes, min_num_points,
                 sample_max_num, removed_difficulties,
                 gt_rot_range=(-np.pi / 4, np.pi / 4),
                 global_rot_range=(-np.pi / 4, np.pi / 4),
                 center_noise_std=(1.0, 1.0, 0.5),
                 scale_range=(0.95, 1.05),
                 rng: Optional[np.random.Generator] = None,
                 db_infos=None):
        self._rng = rng or np.random.default_rng()
        if db_infos is None:
            with open(info_path, "rb") as f:
                db_infos = pickle.load(f)
        self._samplers = []
        if isinstance(min_num_points, int):
            min_num_points = [min_num_points] * len(sample_classes)
        for i, cls in enumerate(sample_classes):
            infos = [x for x in db_infos.get(cls, [])
                     if x["num_points_in_gt"] >= min_num_points[i]
                     and x["difficulty"] not in removed_difficulties]
            self._samplers.append(BatchSampler(infos, rng=self._rng))
        self.root_path = root_path
        self._sample_classes = list(sample_classes)
        self._sample_max_num = (
            [sample_max_num] * len(sample_classes)
            if isinstance(sample_max_num, int) else list(sample_max_num))
        self._global_rot_range = global_rot_range
        self._gt_rot_range = gt_rot_range
        self._center_noise_std = np.asarray(center_noise_std, np.float64)
        self._min_scale, self._max_scale = scale_range

    def sample_all(self, gt_boxes, gt_types):
        """Paste database objects into the scene, avoiding BEV collisions
        with the scene's boxes and each other. Returns (sampled_boxes
        [S,7], sampled_types, sampled_points [P,4])."""
        avoid = gt_boxes
        sampled, sampled_boxes = [], []
        for i, cls in enumerate(self._sample_classes):
            want = int(self._sample_max_num[i]
                       - np.sum([t == cls for t in gt_types]))
            if want <= 0:
                continue
            picked = self._sample_class(avoid, want, i)
            sampled += picked
            if picked:
                boxes = np.stack([s["box3d_lidar"] for s in picked], 0)
                sampled_boxes.append(boxes)
                avoid = np.concatenate([avoid, boxes], 0)
        if not sampled:
            return (np.empty((0, 7), np.float32), [],
                    np.empty((0, 4), np.float32))
        sampled_boxes = np.concatenate(sampled_boxes, 0).astype(np.float32)
        pts_list, types = [], []
        for info in sampled:
            pts = self._load_points(info)
            pts = pts.reshape(-1, 4).copy()
            pts[:, :3] += info["box3d_lidar"][:3].astype(np.float32)
            pts_list.append(pts)
            types.append(info["name"])
        return sampled_boxes, types, np.concatenate(pts_list, 0)

    def _load_points(self, info):
        if "points" in info:                    # an in-memory database
            return np.asarray(info["points"], np.float32)
        return np.fromfile(str(Path(self.root_path) / info["path"]),
                           dtype=np.float32)

    def _sample_class(self, gt_boxes, num, i):
        picked = self._samplers[i].sample(num)
        if not picked:
            return []
        gt_bv = corners_2d(gt_boxes[:, :2], gt_boxes[:, 3:5], gt_boxes[:, 6])
        sp = np.stack([s["box3d_lidar"] for s in picked], 0)
        sp_bv = corners_2d(sp[:, :2], sp[:, 3:5], sp[:, 6])
        total = np.concatenate([gt_bv, sp_bv], 0)
        coll = box_collision_test(total, total)
        np.fill_diagonal(coll, False)
        n_gt = gt_bv.shape[0]
        valid = []
        for k in range(n_gt, n_gt + len(picked)):
            if coll[k].any():
                coll[k] = False
                coll[:, k] = False
            else:
                valid.append(picked[k - n_gt])
        return valid

    def noise_per_object(self, gt_boxes, points, num_try: int = 100):
        """Independent pose noise per GT box: the first of num_try draws
        (in chunks of 8) whose box collides with no other is taken, and the
        points inside the box (the first box holding a point) move with
        it. Mutates and returns (gt_boxes, points)."""
        n = gt_boxes.shape[0]
        if n == 0:
            return gt_boxes, points
        loc_noises = self._rng.normal(
            scale=self._center_noise_std, size=(n, num_try, 3))
        rot_noises = self._rng.uniform(
            self._gt_rot_range[0], self._gt_rot_range[1], size=(n, num_try))

        corners = corners_2d(gt_boxes[:, :2], gt_boxes[:, 3:5], gt_boxes[:, 6])
        point_masks = points_in_rbbox_np(points, gt_boxes)

        chosen_loc = np.zeros((n, 3))
        chosen_rot = np.zeros((n,))
        chunk = 8
        for i in range(n):
            local = corners[i] - gt_boxes[i, :2]
            bmin = corners.min(axis=1)                        # [N, 2]
            bmax = corners.max(axis=1)
            for t0 in range(0, rot_noises.shape[1], chunk):
                rot = rot_noises[i, t0:t0 + chunk]
                c = np.cos(rot)[:, None]
                s = np.sin(rot)[:, None]
                cand = np.stack(
                    [local[None, :, 0] * c + local[None, :, 1] * s,
                     -local[None, :, 0] * s + local[None, :, 1] * c],
                    axis=-1)
                cand += (gt_boxes[i, :2]
                         + loc_noises[i, t0:t0 + chunk, :2][:, None, :])
                cmin = cand.min(axis=1)                       # [T, 2]
                cmax = cand.max(axis=1)
                near = ~np.any(
                    (cmax[:, None] < bmin[None] - 1e-9)
                    | (bmax[None] < cmin[:, None] - 1e-9), axis=-1)  # [T, N]
                near[:, i] = False
                coll = np.zeros(near.shape, bool)
                ti, nj = np.nonzero(near)
                if ti.size:
                    coll[ti, nj] = _sat_collide_pairs(cand[ti], corners[nj])
                ok = ~coll.any(axis=1)
                hit = np.argmax(ok)
                if ok[hit]:
                    chosen_loc[i] = loc_noises[i, t0 + hit]
                    chosen_rot[i] = rot_noises[i, t0 + hit]
                    corners[i] = cand[hit]
                    break

        any_box = point_masks.any(axis=1)
        first = np.argmax(point_masks, axis=1)
        if np.any(any_box):
            idx = np.nonzero(any_box)[0]
            b = first[idx]
            rel = points[idx, :3] - gt_boxes[b, :3]
            c, s = np.cos(chosen_rot[b]), np.sin(chosen_rot[b])
            rx = rel[:, 0] * c + rel[:, 1] * s
            ry = -rel[:, 0] * s + rel[:, 1] * c
            rel = np.stack([rx, ry, rel[:, 2]], 1)
            points[idx, :3] = rel + gt_boxes[b, :3] + chosen_loc[b]

        gt_boxes[:, :3] += chosen_loc
        gt_boxes[:, 6] += chosen_rot
        return gt_boxes, points

    def random_flip(self, gt_boxes, points, probability: float = 0.5):
        if self._rng.uniform() < probability:
            gt_boxes[:, 1] = -gt_boxes[:, 1]
            gt_boxes[:, 6] = -gt_boxes[:, 6] + np.pi
            points[:, 1] = -points[:, 1]
        return gt_boxes, points

    def global_rotation(self, gt_boxes, points):
        angle = self._rng.uniform(*self._global_rot_range)
        points[:, :3] = np.concatenate(
            [rotate_points_z(points[:, :2], angle), points[:, 2:3]], 1)
        gt_boxes[:, :2] = rotate_points_z(gt_boxes[:, :2].copy(), angle)
        gt_boxes[:, 6] += angle
        return gt_boxes, points

    def global_scaling(self, gt_boxes, points):
        scale = self._rng.uniform(self._min_scale, self._max_scale)
        points[:, :3] *= scale
        gt_boxes[:, :6] *= scale
        return gt_boxes, points
