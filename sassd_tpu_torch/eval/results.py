"""Detection output -> KITTI annotation and result files.

A copy of the JAX package's ``eval/results.py``: lidar boxes back to
rect-camera coords, 3D corners projected to 2D image boxes, the alpha
observation angle, clipped to the image.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from sassd_tpu_torch.data import calib as calib_lib
from sassd_tpu_torch.data.augment import corners_2d
from .kitti_eval import empty_anno


def detections_to_kitti_anno(boxes_lidar: np.ndarray, scores: np.ndarray,
                             labels: np.ndarray, valid: np.ndarray,
                             meta: Dict, class_names: List[str]
                             ) -> Dict[str, np.ndarray]:
    """Convert one sample's (padded) detections into a KITTI anno dict."""
    keep = np.asarray(valid, bool)
    boxes = np.asarray(boxes_lidar, np.float64)[keep]
    scores = np.asarray(scores, np.float64)[keep]
    labels = np.asarray(labels)[keep]
    if boxes.shape[0] == 0:
        return empty_anno()
    calib: calib_lib.Calibration = meta["calib"]
    img_h, img_w = meta["img_shape"][:2]

    yaw = boxes[:, 6]
    yaw = yaw - np.floor(yaw / (2 * np.pi) + 0.5) * 2 * np.pi
    loc_cam = calib_lib.project_velo_to_rect(boxes[:, :3], calib)

    # 2D box: project the 8 lidar corners
    c2 = corners_2d(boxes[:, :2], boxes[:, 3:5], yaw)           # [N,4,2]
    zs = np.stack([boxes[:, 2], boxes[:, 2] + boxes[:, 5]], 1)  # [N,2]
    corners = np.concatenate([
        np.repeat(c2, 2, axis=1),                               # [N,8,2]
        np.tile(zs, (1, 4))[..., None]], axis=2)                # [N,8,3]
    rect = calib_lib.project_velo_to_rect(corners.reshape(-1, 3), calib)
    uv = calib_lib.project_rect_to_image(rect, calib).reshape(-1, 8, 2)
    box2d = np.concatenate([uv.min(1), uv.max(1)], 1)

    alphas = -np.arctan2(-boxes[:, 1], boxes[:, 0]) + yaw

    # drop boxes projecting fully outside the image
    ok = ~((box2d[:, 0] > img_w) | (box2d[:, 1] > img_h)
           | (box2d[:, 2] < 0) | (box2d[:, 3] < 0))
    if not np.any(ok):
        return empty_anno()
    box2d = box2d[ok]
    box2d[:, 2] = np.minimum(box2d[:, 2], img_w)
    box2d[:, 3] = np.minimum(box2d[:, 3], img_h)
    box2d[:, :2] = np.maximum(box2d[:, :2], 0.0)

    return dict(
        name=np.array([class_names[int(l)] for l in labels[ok]]),
        truncated=np.zeros(ok.sum()),
        occluded=np.zeros(ok.sum(), np.int64),
        alpha=alphas[ok],
        bbox=box2d,
        dimensions=boxes[ok][:, [4, 5, 3]],     # (l, h, w)
        location=loc_cam[ok].astype(np.float64),
        rotation_y=yaw[ok],
        score=scores[ok])


def anno_to_result_lines(anno: Dict[str, np.ndarray]) -> List[str]:
    """KITTI result-file lines (the devkit's label format plus a score)."""
    lines = []
    for i in range(len(anno["name"])):
        d = anno["dimensions"][i]    # (l, h, w)
        loc = anno["location"][i]
        lines.append(" ".join([
            str(anno["name"][i]), "0.00", "0",
            f"{anno['alpha'][i]:.6f}",
            *[f"{v:.6f}" for v in anno["bbox"][i]],
            f"{d[1]:.6f}", f"{d[2]:.6f}", f"{d[0]:.6f}",   # h w l
            *[f"{v:.6f}" for v in loc],
            f"{anno['rotation_y'][i]:.6f}",
            f"{anno['score'][i]:.6f}"]))
    return lines


def write_result_files(annos: List[Dict[str, np.ndarray]], ids: List[int],
                       out_dir) -> None:
    """One KITTI result file per sample, ``out_dir/{id:06d}.txt``."""
    os.makedirs(out_dir, exist_ok=True)
    for anno, sid in zip(annos, ids):
        with open(os.path.join(out_dir, f"{sid:06d}.txt"), "w") as f:
            f.write("\n".join(anno_to_result_lines(anno)) + "\n")
