"""Host side of the inference input: anchors, anchors mask, host plans.

Every sample is a dict of fixed-shape numpy arrays, so a batch is a plain
``np.stack`` (:func:`collate`).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from sassd_tpu_torch.config import SASSDConfig
from sassd_tpu_torch.core import anchors as anchor_lib
from sassd_tpu_torch.ops import native
from sassd_tpu_torch.ops.voxelize import voxelize_np


def nearest_bev_np(boxes: np.ndarray) -> np.ndarray:
    """[A,7] -> [A,4] nearest axis-aligned BEV box (xmin, ymin, xmax, ymax)."""
    rots = boxes[:, 6] - np.floor(boxes[:, 6] / np.pi + 0.5) * np.pi
    cond = np.abs(rots) > np.pi / 4
    dx = np.where(cond, boxes[:, 4], boxes[:, 3])
    dy = np.where(cond, boxes[:, 3], boxes[:, 4])
    return np.stack([boxes[:, 0] - dx / 2, boxes[:, 1] - dy / 2,
                     boxes[:, 0] + dx / 2, boxes[:, 1] + dy / 2], axis=1)


def build_anchors(cfg: SASSDConfig):
    """Per-class anchor grids flattened class-major to [A, 7], plus their
    nearest-BEV boxes [A, 4]. The feature map is the voxel grid //
    out_size_factor."""
    h, w = cfg.bev_map_size
    flats = []
    for ac in cfg.anchors.values():
        grid = anchor_lib.create_anchors_3d_stride(
            (1, h, w), ac.sizes, ac.strides, ac.offsets, ac.rotations)
        flats.append(grid.reshape(-1, 7).astype(np.float32))
    anchors = np.concatenate(flats, 0)
    return anchors, nearest_bev_np(anchors)


def build_host_plans(cfg: SASSDConfig,
                     coords: np.ndarray) -> Dict[str, np.ndarray]:
    """C++ host rulebook of the sparse backbone, as ``plan_*`` arrays;
    none with ``model.host_plans=False`` (the device builds them).

    Plans travel as int16 when every row index fits (-1 = missing), which
    halves the host-to-device bytes.
    """
    if not cfg.model.host_plans:
        return {}
    caps = (cfg.voxel.max_voxels,) + tuple(cfg.caps.level_caps[1:])
    plans = native.build_plans_cpp(coords, cfg.sparse_shape, caps)
    narrow = max(caps) < np.iinfo(np.int16).max
    out = {}
    for k, v in plans.items():
        if k == "n_active":
            continue
        if narrow and k.startswith(("subm", "stride")):
            v = v.astype(np.int16)
        out[f"plan_{k}"] = v
    return out


def prepare_scan(cfg: SASSDConfig, points: np.ndarray,
                 anchors_bv: np.ndarray) -> Dict[str, np.ndarray]:
    """Raw [N, F] points -> one sample: voxels, the anchors mask (anchors
    whose BEV footprint covers more than anchor_area_threshold voxels) and
    the host plans, if the config asks for them."""
    voxels, coords, nums = voxelize_np(points, cfg.voxel, pad=True)
    mask = native.anchors_mask_cpp(
        coords, anchors_bv, cfg.voxel.voxel_size,
        np.asarray(cfg.voxel.point_cloud_range), cfg.voxel.grid_size,
        cfg.data.anchor_area_threshold)
    out = dict(voxels=voxels, num_points=nums, coords=coords,
               anchors_mask=mask)
    out.update(build_host_plans(cfg, coords))
    return out


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack fixed-shape samples into a batch."""
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
