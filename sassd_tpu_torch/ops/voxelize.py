"""Voxelization: on the host through the C++ library, and on the device.

Voxel layout: voxels [M, T, F] (zero-padded), coords [M, 3] zyx int32
(padded rows = -1), num_points [M]. Rows are sorted ascending by the
linear zyx key, padding last.

- :func:`voxelize_np` (host, the loader's path): per-voxel contents and the
  max_voxels cut keep first-come semantics.
- :func:`bound_points_np` crops points to a range box;
  :func:`points_to_bev_np` (host) and :func:`points_to_bev` (a tensor
  function on the caller's device) rasterise points into a handcrafted BEV
  map. No path of the detector calls these three.
- :func:`voxelize` (device serving, K8 ``csrc/voxelize.cu`` on the card,
  :func:`voxelize_plain` on the CPU): first-come slots inside a voxel (the
  plain version by a stable key sort, K8 without one), and the max_voxels
  cut keeps the lowest keys, as the JAX package's ``voxelize_jax``. Below
  the cap both give the same voxels.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from sassd_tpu_torch.config import VoxelConfig
from . import cuda, native

INVALID_KEY = torch.iinfo(torch.int32).max

_K8 = cuda.Kernel("sassd_voxelize",
                  [cuda.P, cuda.P, cuda.I, cuda.I, cuda.I] + [cuda.F] * 6
                  + [cuda.I] * 6 + [cuda.P, cuda.P, cuda.P, cuda.P])
# K8's bitmap tile: 1024 32-bit words (32,768 grid cells) a block
K8_TILE_CELLS = 32768
# the C entry points of the kernel, for launch counts
KERNEL_SYMBOLS = {"K8": ("sassd_voxelize",)}


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


def voxelize_plain(points: torch.Tensor, n_points: torch.Tensor,
                   cfg: VoxelConfig):
    """Plain PyTorch version of K8 (see voxelize)."""
    b, p, f = points.shape
    dev = points.device
    gx, gy, gz = (int(g) for g in cfg.grid_size)
    t_max, vmax = cfg.max_num_points, cfg.max_voxels
    pcr = torch.tensor(cfg.point_cloud_range[:3], dtype=torch.float32,
                       device=dev)
    vs = torch.tensor(cfg.voxel_size, dtype=torch.float32, device=dev)
    c = torch.floor((points[..., :3] - pcr) / vs).to(torch.int32)
    grid = torch.tensor([gx, gy, gz], dtype=torch.int32, device=dev)
    ar = torch.arange(p, device=dev)
    ok = ((ar[None] < n_points[:, None])
          & ((c >= 0) & (c < grid)).all(-1))
    c = torch.where(ok[..., None], c, 0)
    keys = torch.where(ok, (c[..., 2] * gy + c[..., 1]) * gx + c[..., 0],
                       INVALID_KEY)

    ks, perm = torch.sort(keys, dim=1, stable=True)
    real = ks != INVALID_KEY
    first = real.clone()
    first[:, 1:] &= ks[:, 1:] != ks[:, :-1]
    vox_id = torch.cumsum(first.to(torch.int64), 1) - 1
    run_start = torch.cummax(torch.where(first, ar, 0), 1).values
    slot = ar - run_start
    vrow = torch.where(real & (vox_id < vmax), vox_id, vmax)
    bidx = torch.arange(b, device=dev)[:, None].expand(b, p)

    voxels = points.new_zeros((b, vmax + 1, t_max + 1, f))
    voxels[bidx, vrow, slot.clamp(max=t_max)] = torch.gather(
        points, 1, perm[..., None].expand(b, p, f))
    num_points = torch.zeros((b, vmax + 1), dtype=torch.int32, device=dev)
    num_points.scatter_reduce_(
        1, vrow, (slot + 1).clamp(max=t_max).to(torch.int32), "amax")
    coords = torch.full((b, vmax + 1, 3), -1, dtype=torch.int32, device=dev)
    cs = torch.gather(c, 1, perm[..., None].expand(b, p, 3))
    coords[bidx, vrow] = cs.flip(-1)                       # xyz -> zyx
    return (voxels[:, :vmax, :t_max].contiguous(), coords[:, :vmax],
            num_points[:, :vmax])


def voxelize(points: torch.Tensor, n_points: torch.Tensor, cfg: VoxelConfig):
    """Raw padded points -> key-sorted voxels, on the points' device.

    points: [B, P, F] float32 (xyz first, rows >= n_points[b] ignored);
    n_points: [B] int32. Returns voxels [B, max_voxels, T, F] (zero
    padded), coords [B, max_voxels, 3] int32 zyx (-1 padded) and
    num_points [B, max_voxels] int32; the max_voxels lowest keys win the
    cap. K8 on the card: a bitmap of the grid, ranked, no sort.
    """
    if points.device.type == "cpu":
        return voxelize_plain(points, n_points, cfg)
    cuda.check_cuda("points", points, torch.float32, 3)
    cuda.check_cuda("n_points", n_points, torch.int32, 1)
    b, p, f = points.shape
    if f < 3 or n_points.shape[0] != b:
        raise ValueError(f"points {tuple(points.shape)} / n_points "
                         f"{tuple(n_points.shape)} are not [B, P, F>=3] / "
                         f"[B]")
    if n_points.device != points.device:
        raise ValueError("points and n_points must be on one device")
    gx, gy, gz = (int(g) for g in cfg.grid_size)
    if gx * gy * gz >= INVALID_KEY:
        raise ValueError(f"grid {cfg.grid_size} has more cells than int32 "
                         f"keys can name")
    t_max, vmax = cfg.max_num_points, cfg.max_voxels
    tiles = -(-(gx * gy * gz) // K8_TILE_CELLS)
    dev = points.device
    with torch.cuda.device(dev):
        # scratch (int32): bitmap, tile counts, tile bases, totals, point
        # keys, sorted keys, slots; K8 clears what it needs
        scratch = torch.empty(
            b * (tiles * (K8_TILE_CELLS // 32 + 2) + 1 + p
                 + vmax * (1 + t_max)), dtype=torch.int32, device=dev)
        voxels = torch.empty((b, vmax, t_max, f), dtype=torch.float32,
                             device=dev)
        coords = torch.empty((b, vmax, 3), dtype=torch.int32, device=dev)
        num_points = torch.empty((b, vmax), dtype=torch.int32, device=dev)
        _K8.launch(points.data_ptr(), n_points.data_ptr(), b, p, f,
                   *cfg.point_cloud_range[:3], *cfg.voxel_size,
                   gx, gy, gz, vmax, t_max, tiles, scratch.data_ptr(),
                   voxels.data_ptr(), coords.data_ptr(),
                   num_points.data_ptr())
    return voxels, coords, num_points


def bound_points_np(points: np.ndarray, pcr: Sequence[float]) -> np.ndarray:
    """The [N, F] points inside the range box (xmin, ymin, zmin, xmax,
    ymax, zmax), lower faces included."""
    m = ((points[:, 0] >= pcr[0]) & (points[:, 0] < pcr[3])
         & (points[:, 1] >= pcr[1]) & (points[:, 1] < pcr[4])
         & (points[:, 2] >= pcr[2]) & (points[:, 2] < pcr[5]))
    return points[m]


def points_to_bev_np(points: np.ndarray, cfg: VoxelConfig) -> np.ndarray:
    """[N, 4] points (xyz, reflectance) -> [Z + 2, H, W] float32 BEV map:
    channels 0..Z-1 the occupancy of each z bin, Z the largest
    reflectance in each BEV cell (0 where empty) and Z + 1 its point
    count (the reference's points_to_bev_kernel)."""
    gx, gy, gz = (int(g) for g in cfg.grid_size)
    pcr = np.asarray(cfg.point_cloud_range, np.float32)
    vs = np.asarray(cfg.voxel_size, np.float32)
    c = np.floor((points[:, :3] - pcr[:3]) / vs).astype(np.int64)
    ok = np.all((c >= 0) & (c < np.array([gx, gy, gz])), axis=1)
    x, y, z = c[ok, 0], c[ok, 1], c[ok, 2]
    bev = np.zeros((gz + 2, gy, gx), np.float32)
    bev[z, y, x] = 1.0
    np.maximum.at(bev[gz], (y, x), points[ok, 3])
    np.add.at(bev[gz + 1], (y, x), 1.0)
    return bev


def points_to_bev(points: torch.Tensor, valid: torch.Tensor,
                  cfg: VoxelConfig) -> torch.Tensor:
    """points_to_bev_np on the points' device over fixed-shape input:
    [N, 4] float32 points and an [N] bool mask of the rows to count."""
    gx, gy, gz = (int(g) for g in cfg.grid_size)
    dev = points.device
    pcr = torch.tensor(cfg.point_cloud_range[:3], dtype=torch.float32,
                       device=dev)
    vs = torch.tensor(cfg.voxel_size, dtype=torch.float32, device=dev)
    grid = torch.tensor([gx, gy, gz], device=dev)
    c = torch.floor((points[:, :3] - pcr) / vs).to(torch.int64)
    ok = valid & ((c >= 0) & (c < grid)).all(-1)
    c = torch.where(ok[:, None], c, 0)
    cell = c[:, 1] * gx + c[:, 0]                          # y * W + x
    okf = ok.to(torch.float32)
    occ = torch.zeros(gz * gy * gx, dtype=torch.float32, device=dev)
    occ.scatter_reduce_(0, c[:, 2] * (gy * gx) + cell, okf, "amax")
    inten = torch.zeros(gy * gx, dtype=torch.float32, device=dev)
    inten.scatter_reduce_(0, cell, torch.where(ok, points[:, 3], 0.0),
                          "amax")
    dens = torch.zeros(gy * gx, dtype=torch.float32, device=dev)
    dens.index_put_((cell,), okf, accumulate=True)
    return torch.cat([occ.view(gz, gy, gx), inten.view(1, gy, gx),
                      dens.view(1, gy, gx)])
