"""Host voxelization through the C++ library.

Voxel layout: voxels [M, T, F] (zero-padded), coords [M, 3] zyx int32
(padded rows = -1), num_points [M]. Rows are sorted ascending by the
linear zyx key, padding last; per-voxel contents and the max_voxels cut
keep first-come semantics.
"""
from __future__ import annotations

import numpy as np

from sassd_tpu_torch.config import VoxelConfig
from . import native


def voxelize_np(points: np.ndarray, cfg: VoxelConfig, pad: bool = False):
    """[N, F] points -> (voxels, coords, num_points), key-sorted rows.

    With pad=True the outputs keep the static [max_voxels, ...] shapes.
    """
    v, c, n, m = native.voxelize_cpp(
        points, np.asarray(cfg.point_cloud_range[:3], np.float32),
        np.asarray(cfg.voxel_size, np.float32), cfg.grid_size,
        cfg.max_num_points, cfg.max_voxels)
    v, c, n = _sort_rows_by_key(v, c, n, cfg.grid_size)
    if pad:
        return v, c, n
    return v[:m], c[:m], n[:m]


def _sort_rows_by_key(voxels, coords, nums, grid_xyz):
    """Reorder rows ascending by (z*H + y)*W + x; -1 padding sinks last."""
    gx, gy = int(grid_xyz[0]), int(grid_xyz[1])
    z = coords[:, 0].astype(np.int64)
    key = (z * gy + coords[:, 1]) * gx + coords[:, 2]
    key = np.where(z >= 0, key, np.iinfo(np.int64).max)
    perm = np.argsort(key, kind="stable")
    return voxels[perm], coords[perm], nums[perm]
