"""Box geometry of the JAX package's ``data/augment.py`` that inference
needs: BEV corners (result files) and nearest axis-aligned BEV boxes
(anchors mask). The training augmentations are not carried."""
from __future__ import annotations

from typing import Optional

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
