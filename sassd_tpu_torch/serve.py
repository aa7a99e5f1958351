"""Device-resident serving: raw padded point clouds in, detections out.

The loader's whole per-scan job is a range crop and a pad
(:func:`prepare_points`); the upload is the raw points (1 MB at the car
config's 65,536-point cap). On the device:

    points [B, P, F] --K8 voxelize (ops/voxelize.py)--> key-sorted voxels
      --K9 anchors mask (integral image, static corner table)-->
      --device rulebook (K6, K7; Detector.forward_spine)--> forward_test

Select it with ``TestConfig.device_input = "points"``
(``inference.run_inference`` honours it). The sparse path always runs on
the device rulebook here: there is no loader to build host plans.

Kernels (``sassd_tpu_torch/csrc``), each beside its plain PyTorch version,
which a wrapper takes only for CPU tensors: K8 ``voxelize.cu`` and K9
``anchors_mask.cu`` (:func:`anchors_mask`).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from sassd_tpu_torch.config import SASSDConfig, check_supported
from sassd_tpu_torch.models.detector import Detector
from sassd_tpu_torch.ops import cuda
from sassd_tpu_torch.ops.voxelize import voxelize

_K9_INTEGRAL = cuda.Kernel("sassd_integral_image",
                           [cuda.P, cuda.I, cuda.I, cuda.I, cuda.I, cuda.P])
_K9_MASK = cuda.Kernel("sassd_anchors_mask",
                       [cuda.P, cuda.P, cuda.I, cuda.I, cuda.I, cuda.I,
                        cuda.F, cuda.P])
# the C entry points of the kernel, for launch counts
KERNEL_SYMBOLS = {"K9": ("sassd_integral_image", "sassd_anchors_mask")}


# ---------------------------------------------------------------------------
# anchors mask
# ---------------------------------------------------------------------------

def anchor_corner_indices(anchors_bv: np.ndarray, voxel_size, pc_range,
                          grid_size) -> np.ndarray:
    """Static per-config BEV corner cells [A, 4] int32 (x0, y0, x1, y1).

    The quantisation of the host mask (C++ ``anchors_mask``), in float32:
    anchor edges land exactly on voxel grid lines, where a float64 floor
    can land one cell lower.
    """
    w, h = int(grid_size[0]), int(grid_size[1])
    bv = anchors_bv.astype(np.float32)
    pcr = np.asarray(pc_range, np.float32)
    vs = np.asarray(voxel_size, np.float32)
    x0 = np.clip(np.floor((bv[:, 0] - pcr[0]) / vs[0]).astype(np.int32),
                 0, w - 1)
    y0 = np.clip(np.floor((bv[:, 1] - pcr[1]) / vs[1]).astype(np.int32),
                 0, h - 1)
    x1 = np.clip(np.floor((bv[:, 2] - pcr[0]) / vs[0]).astype(np.int32),
                 0, w - 1)
    y1 = np.clip(np.floor((bv[:, 3] - pcr[1]) / vs[1]).astype(np.int32),
                 0, h - 1)
    return np.stack([x0, y0, x1, y1], axis=1)


def integral_image_plain(coords_zyx: torch.Tensor,
                         grid_hw: Tuple[int, int]) -> torch.Tensor:
    """[B, V, 3] zyx coords (-1 rows = padding) -> [B, H, W] float32
    inclusive integral image of the BEV voxel counts."""
    h, w = grid_hw
    b = coords_zyx.shape[0]
    c = coords_zyx.to(torch.int64)
    base = torch.arange(b, device=c.device)[:, None] * (h * w)
    flat = torch.where(c[..., 0] >= 0, base + c[..., 1] * w + c[..., 2],
                       b * h * w)
    dense = torch.zeros(b * h * w + 1, dtype=torch.float32, device=c.device)
    dense.index_add_(0, flat.reshape(-1),
                     torch.ones(flat.numel(), device=c.device))
    return dense[:b * h * w].view(b, h, w).cumsum(1).cumsum(2)


def anchors_mask_plain(coords_zyx: torch.Tensor, corners: torch.Tensor,
                       grid_hw: Tuple[int, int],
                       threshold: float) -> torch.Tensor:
    """Plain PyTorch version of K9 (see anchors_mask)."""
    integral = integral_image_plain(coords_zyx, grid_hw)
    x0, y0, x1, y1 = corners.to(torch.int64).unbind(1)
    area = (integral[:, y1, x1] - integral[:, y0, x1]
            - integral[:, y1, x0] + integral[:, y0, x0])
    return area > threshold


def anchors_mask(coords_zyx: torch.Tensor, corners: torch.Tensor,
                 grid_hw: Tuple[int, int], threshold: float) -> torch.Tensor:
    """BEV occupancy prefilter on the coords' device.

    coords_zyx: [B, V, 3] int32 (-1 rows = padding); corners: [A, 4] int32
    from :func:`anchor_corner_indices`; grid_hw: the voxel grid's (H, W).
    Returns [B, A] bool: anchors whose footprint covers more than
    `threshold` voxels, in the anchor order (class -> y -> x -> rot). K9
    on the card.
    """
    if coords_zyx.device.type == "cpu":
        return anchors_mask_plain(coords_zyx, corners, grid_hw, threshold)
    cuda.check_cuda("coords_zyx", coords_zyx, torch.int32, 3)
    cuda.check_cuda("corners", corners, torch.int32, 2)
    b, v, three = coords_zyx.shape
    a = corners.shape[0]
    if three != 3 or corners.shape[1] != 4:
        raise ValueError(f"coords {tuple(coords_zyx.shape)} / corners "
                         f"{tuple(corners.shape)} are not [B, V, 3] / [A, 4]")
    if corners.device != coords_zyx.device or corners.data_ptr() % 16:
        raise ValueError("corners must be 16-byte aligned on the coords' "
                         "device")
    h, w = grid_hw
    dev = coords_zyx.device
    with torch.cuda.device(dev):
        integral = torch.empty((b, h, w), dtype=torch.float32, device=dev)
        _K9_INTEGRAL.launch(coords_zyx.data_ptr(), b, v, h, w,
                            integral.data_ptr())
        mask = torch.empty((b, a), dtype=torch.bool, device=dev)
        _K9_MASK.launch(integral.data_ptr(), corners.data_ptr(), b, a, h, w,
                        float(threshold), mask.data_ptr())
    return mask


# ---------------------------------------------------------------------------
# host-side input prep (the only per-scan host work in this mode)
# ---------------------------------------------------------------------------

def prepare_points(points: np.ndarray,
                   cfg: SASSDConfig) -> Tuple[np.ndarray, np.int32]:
    """Range-crop + pad a raw scan to [caps.max_points_per_scan, F] f32.

    Points beyond the cap are dropped (the voxel budget saturates first:
    max_voxels * max_num_points is below the 65,536-point cap).
    """
    pcr = cfg.voxel.point_cloud_range
    m = ((points[:, 0] >= pcr[0]) & (points[:, 0] < pcr[3])
         & (points[:, 1] >= pcr[1]) & (points[:, 1] < pcr[4])
         & (points[:, 2] >= pcr[2]) & (points[:, 2] < pcr[5]))
    pts = points[m]
    cap = cfg.caps.max_points_per_scan
    n = min(len(pts), cap)
    out = np.zeros((cap, points.shape[1]), np.float32)
    out[:n] = pts[:n]
    return out, np.int32(n)


# ---------------------------------------------------------------------------
# the serving step
# ---------------------------------------------------------------------------

def batch_from_points(points: torch.Tensor, n_points: torch.Tensor,
                      corners: torch.Tensor,
                      cfg: SASSDConfig) -> Dict[str, torch.Tensor]:
    """Voxelize + anchors mask on the points' device.

    points [B, P, F] float32 (zero padded), n_points [B] int32, corners
    [A, 4] int32 (anchor_corner_indices). Returns the test batch (voxels,
    num_points, coords, anchors_mask) with no ``plan_*`` keys, so
    ``Detector.forward_spine`` builds the rulebook on the device.
    """
    with record_function("voxelize"):
        voxels, coords, nums = voxelize(points, n_points, cfg.voxel)
    with record_function("anchors_mask"):
        gh, gw = int(cfg.voxel.grid_size[1]), int(cfg.voxel.grid_size[0])
        mask = anchors_mask(coords, corners, (gh, gw),
                            cfg.data.anchor_area_threshold)
    return dict(voxels=voxels, num_points=nums, coords=coords,
                anchors_mask=mask)


def make_serving_step(cfg: SASSDConfig, anchors: np.ndarray,
                      anchors_bv: np.ndarray, device
                      ) -> Callable[[Detector, Dict[str, np.ndarray]],
                                    Dict[str, torch.Tensor]]:
    """Returns step(model, batch) -> detections on `device` (not synced),
    where batch is dict(points [B, P, F] f32, n_points [B] int32) in
    numpy; the upload is inside the step. The corner table and the anchors
    are uploaded once, here. The step puts the model in eval mode and runs
    without autograd."""
    check_supported(cfg)
    corners = torch.from_numpy(anchor_corner_indices(
        anchors_bv, cfg.voxel.voxel_size, cfg.voxel.point_cloud_range,
        cfg.voxel.grid_size)).to(device)
    anchors_t = torch.from_numpy(np.asarray(anchors, np.float32)).to(device)

    def step(model: Detector, batch: Dict[str, np.ndarray]):
        model.eval()
        with torch.inference_mode():
            points, n_points = (torch.from_numpy(np.ascontiguousarray(
                batch[k])).to(device) for k in ("points", "n_points"))
            full = batch_from_points(points, n_points, corners, cfg)
            return model.forward_test(full, anchors_t)
    return step


class PointsView:
    """Dataset adapter for device-resident serving: wraps any dataset with
    a `load_points(idx) -> (points, meta)` method and yields dict(points
    [P, F] f32, n_points int32, meta) samples."""

    def __init__(self, dataset, cfg: SASSDConfig):
        self.dataset = dataset
        self.cfg = cfg

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        points, meta = self.dataset.load_points(idx)
        pts, n = prepare_points(points, self.cfg)
        return dict(points=pts, n_points=np.asarray(n), meta=meta)
