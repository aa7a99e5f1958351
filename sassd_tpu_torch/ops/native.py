"""ctypes binding of the C++ host library (``csrc/sassd_host.cpp``).

The source is the JAX package's, unchanged; this module compiles it with
``g++`` into the port's build directory at first use. There is no numpy
fallback: if the library cannot be built, every entry point raises, so a
missing compiler never silently changes which plans the model runs on.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from .build import REPO_DIR, build_shared

SOURCE = REPO_DIR / "csrc" / "sassd_host.cpp"
CXX_COMMAND = ["g++", "-O3", "-fPIC", "-std=c++17"]
LINK_COMMAND = ["g++", "-shared"]
_lib: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    """Build (if needed) and load the host library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_shared("sassd_host", [SOURCE], CXX_COMMAND,
                                       LINK_COMMAND)))
    i64 = ctypes.c_int64
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
    lib.voxelize.restype = i64
    lib.voxelize.argtypes = [f32p, i64, i64, f32p, f32p, i64p, i64, i64,
                             f32p, i32p, i32p]
    lib.build_plans.restype = ctypes.c_int
    lib.build_plans.argtypes = [i32p, i64p, i64p] + [i32p] * 16 + [i64p, i64]
    lib.anchors_mask.restype = None
    lib.anchors_mask.argtypes = [i32p, i64, f32p, i64, f32p, f32p, i64p,
                                 ctypes.c_float, u8p]
    lib.rotated_overlap.restype = None
    lib.rotated_overlap.argtypes = [f64p, i64, f64p, i64, ctypes.c_int, f32p]
    _lib = lib
    return lib


def voxelize_cpp(points: np.ndarray, pc_min, voxel_size, grid,
                 max_pts: int, max_voxels: int):
    """First-come voxelization. Returns (voxels, coords, num, m)."""
    lib = load()
    points = np.ascontiguousarray(points, np.float32)
    if points.ndim != 2 or points.shape[1] < 3:
        raise ValueError(f"points must be [N, F>=3], got {points.shape}")
    n, f = points.shape
    voxels = np.zeros((max_voxels, max_pts, f), np.float32)
    coords = np.full((max_voxels, 3), -1, np.int32)
    nums = np.zeros((max_voxels,), np.int32)
    m = lib.voxelize(points, n, f,
                     np.ascontiguousarray(pc_min, np.float32),
                     np.ascontiguousarray(voxel_size, np.float32),
                     np.ascontiguousarray(grid, np.int64),
                     max_pts, max_voxels, voxels, coords, nums)
    return voxels, coords, nums, int(m)


def build_plans_cpp(coords0: np.ndarray, sparse_shape, level_caps,
                    train: bool = False):
    """Gather plans of the sparse backbone from level-0 coords.

    Args:
      coords0: [cap0, 3] int32 zyx coords (-1 rows = padding), key-sorted.
      sparse_shape: (D, H, W) of the full-resolution grid.
      level_caps: 4 per-level capacities (cap0 == coords0.shape[0]).
      train: also build the plans only the backward and the aux branch read.
    Returns:
      dict with subm0..subm3 ([27, capL] int32, -1 = missing),
      stride1..stride3 ([27, capL], rows of the previous level),
      coords1..coords3 ([capL, 3] int32, -1 padded) and n_active [4]; with
      train also strideT1..3 ([27, cap_{L-1}], the stride convs' transpose
      plans: rows of level L for each level L-1 row) and aux1..3 ([27,
      cap0], the level-L rows of the 3x3x3 ring around each level-0 voxel's
      parent cell).
    """
    lib = load()
    caps = np.asarray(level_caps, np.int64)
    if coords0.shape != (int(caps[0]), 3):
        raise ValueError(f"coords0 {coords0.shape} does not match cap "
                         f"{int(caps[0])}")
    dims = np.asarray(sparse_shape, np.int64)
    out = {f"subm{l}": np.empty((27, int(caps[l])), np.int32)
           for l in range(4)}
    unused = np.empty((1,), np.int32)
    for l in range(1, 4):
        out[f"coords{l}"] = np.empty((int(caps[l]), 3), np.int32)
        out[f"stride{l}"] = np.empty((27, int(caps[l])), np.int32)
        if train:
            out[f"aux{l}"] = np.empty((27, int(caps[0])), np.int32)
            out[f"strideT{l}"] = np.empty((27, int(caps[l - 1])), np.int32)
    n_out = np.zeros(4, np.int64)
    rc = lib.build_plans(np.ascontiguousarray(coords0, np.int32), caps, dims,
                         out["subm0"], out["coords1"], out["subm1"],
                         out["stride1"], out["coords2"], out["subm2"],
                         out["stride2"], out["coords3"], out["subm3"],
                         out["stride3"],
                         *[out.get(f"aux{l}", unused) for l in (1, 2, 3)],
                         *[out.get(f"strideT{l}", unused) for l in (1, 2, 3)],
                         n_out, int(train))
    if rc != 0:
        raise RuntimeError(f"build_plans failed with code {rc}")
    out["n_active"] = n_out.astype(np.int32)
    return out


def anchors_mask_cpp(coords, anchors_bv, voxel_size, pc_range, grid,
                     threshold: float) -> np.ndarray:
    """BEV-occupancy anchors mask: [A] bool."""
    lib = load()
    coords = np.ascontiguousarray(coords, np.int32)
    bv = np.ascontiguousarray(anchors_bv, np.float32)
    out = np.zeros((bv.shape[0],), np.uint8)
    lib.anchors_mask(coords, coords.shape[0], bv, bv.shape[0],
                     np.ascontiguousarray(voxel_size, np.float32),
                     np.ascontiguousarray(pc_range[:3], np.float32),
                     np.ascontiguousarray(grid, np.int64),
                     float(threshold), out)
    return out.astype(bool)


def rotated_overlap_cpp(boxes: np.ndarray, qboxes: np.ndarray,
                        criterion: int = 2) -> np.ndarray:
    """Pairwise rotated BEV overlap of [N, 5] x [K, 5] (cx, cy, w, l, yaw)
    boxes in float64, as [N, K] float32: criterion -1 IoU, 0 inter/area1,
    1 inter/area2, 2 the raw intersection area."""
    lib = load()
    boxes = np.ascontiguousarray(boxes, np.float64)
    qboxes = np.ascontiguousarray(qboxes, np.float64)
    if boxes.ndim != 2 or boxes.shape[1] != 5 or qboxes.ndim != 2 \
            or qboxes.shape[1] != 5:
        raise ValueError(f"boxes must be [N, 5], got {boxes.shape} and "
                         f"{qboxes.shape}")
    out = np.zeros((boxes.shape[0], qboxes.shape[0]), np.float32)
    if boxes.size and qboxes.size:
        lib.rotated_overlap(boxes, boxes.shape[0], qboxes, qboxes.shape[0],
                            int(criterion), out)
    return out
