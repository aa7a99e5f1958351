"""Box geometry of the JAX package's ``data/augment.py``: BEV corners
(result files, the GT range filter) and nearest axis-aligned BEV boxes
(anchors mask). The GT-sampling augmentor is not carried."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


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
