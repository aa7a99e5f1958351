"""Rotated BEV overlaps in numpy for the KITTI evaluator, on the C++ host
library's polygon clip (``csrc/sassd_host.cpp`` ``rotated_overlap``).

There is no numpy fallback: without the library these raise (see
``ops/native.py``).
"""
from __future__ import annotations

import numpy as np

from sassd_tpu_torch.ops import native


def rotate_overlap_bev_np(boxes1, boxes2) -> np.ndarray:
    """Pairwise rotated intersection areas ([N,5] x [M,5] -> [N,M] f64)."""
    boxes1 = np.asarray(boxes1, np.float64)
    boxes2 = np.asarray(boxes2, np.float64)
    return native.rotated_overlap_cpp(boxes1, boxes2, 2).astype(np.float64)


def rotate_iou_eval_np(boxes1, boxes2, criterion: int = -1) -> np.ndarray:
    """Pairwise rotated IoU with the evaluator's criterion variants.

    criterion=-1: IoU; 0: inter/area1; 1: inter/area2; any other value:
    the raw intersection area. Returns [N, M] float32.
    """
    boxes1 = np.asarray(boxes1, np.float64)
    boxes2 = np.asarray(boxes2, np.float64)
    if boxes1.shape[0] == 0 or boxes2.shape[0] == 0:
        return np.zeros((boxes1.shape[0], boxes2.shape[0]), np.float32)
    inter = rotate_overlap_bev_np(boxes1, boxes2)
    a1 = (boxes1[:, 2] * boxes1[:, 3])[:, None]
    a2 = (boxes2[:, 2] * boxes2[:, 3])[None, :]
    if criterion == -1:
        denom = np.maximum(a1 + a2 - inter, 1e-9)
    elif criterion == 0:
        denom = np.maximum(a1, 1e-9)
    elif criterion == 1:
        denom = np.maximum(a2, 1e-9)
    else:
        denom = np.ones_like(a1 + a2)
    return (inter / denom).astype(np.float32)
