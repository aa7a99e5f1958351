"""Device-resident serving: raw padded point clouds in, detections out.

The loader's whole per-scan job is a range crop and a pad
(:func:`prepare_points`); the upload is the raw points (1 MB at the car
config's 65,536-point cap). On the device:

    points [B, P, F] --K8 voxelize (ops/voxelize.py)--> key-sorted voxels
      --K9 anchors mask (integral image on the corner lattice, static
        tables)--> --device rulebook (K6, K7; Detector.forward_spine)-->
      forward_test

Select it with ``TestConfig.device_input = "points"``
(``inference.run_inference`` honours it). The sparse path always runs on
the device rulebook here: there is no loader to build host plans.

With ``TestConfig.serve_persistent_plans`` at batch 1, one stream of
scans: the index maps of levels 0-2 live across scans in a carry
(:func:`init_plan_carry`), and each scan's rulebook
(:func:`plans_from_carry`) clears the previous scan's rows and sets its
own (K17, ``ops/sparse.update_index_maps``, the three levels in one call)
where the per-scan rulebook fills each map afresh (K6's memset and
scatter): the same plans, bit for bit.

Kernels (``sassd_tpu_torch/csrc``), each beside its plain PyTorch version,
which a wrapper takes only for CPU tensors: K8 ``voxelize.cu`` and K9
``anchors_mask.cu`` (:func:`anchors_mask`, on the tables of
:func:`anchor_lattice`).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from sassd_tpu_torch.config import SASSDConfig, check_supported
from sassd_tpu_torch.models.detector import Detector
from sassd_tpu_torch.models.backbone import level_shapes
from sassd_tpu_torch.ops import cuda
from sassd_tpu_torch.ops import sparse as sp
from sassd_tpu_torch.ops.voxelize import voxelize

_K9 = cuda.Kernel("sassd_anchors_mask",
                  [cuda.P, cuda.I, cuda.I, cuda.P, cuda.I, cuda.P, cuda.I,
                   cuda.P, cuda.I, cuda.I, cuda.I, cuda.F, cuda.P, cuda.P])
# the C entry points of the kernel, for launch counts
KERNEL_SYMBOLS = {"K9": ("sassd_anchors_mask",)}


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


class AnchorLattice(NamedTuple):
    """K9's static tables (:func:`anchor_lattice`): the compressed corner
    lattice of a corner table.

    The mask reads the integral image only at the anchors' corner rows and
    columns, so K9 keeps it on the lattice of those rows and columns: Y
    and X, the sorted distinct corner values. Grid row y maps to lattice
    row ``ymap[y]`` = searchsorted_left(Y, y), the first corner row at or
    past y (-1 past the last corner row: such a cell is in no anchor), and
    likewise for columns. Since x0 < x <= x1 holds exactly when
    x0 < X[xmap[x]] <= x1, the lattice's inclusive integral read at the
    corners' lattice indices gives the grid's counts exactly.
    """
    corners: torch.Tensor          # [A, 4] int32 grid cells (x0, y0, x1, y1)
    ymap: torch.Tensor             # [H] int32 lattice row of each grid row
    xmap: torch.Tensor             # [W] int32 lattice column, or -1
    lattice_corners: torch.Tensor  # [A, 4] int32 (x0, y0, x1, y1), lattice
    shape: Tuple[int, int]         # (LY, LX) = (|Y|, |X|)

    @property
    def grid_hw(self) -> Tuple[int, int]:
        return self.ymap.shape[0], self.xmap.shape[0]

    def to(self, device) -> "AnchorLattice":
        return self._replace(corners=self.corners.to(device),
                             ymap=self.ymap.to(device),
                             xmap=self.xmap.to(device),
                             lattice_corners=self.lattice_corners.to(device))


def anchor_lattice(corners: np.ndarray,
                   grid_hw: Tuple[int, int]) -> AnchorLattice:
    """The lattice tables of a [A, 4] int32 corner table
    (:func:`anchor_corner_indices`) on an (H, W) grid, as CPU tensors."""
    h, w = grid_hw
    corners = np.ascontiguousarray(corners, np.int32).reshape(-1, 4)
    if corners.size and (corners.min() < 0 or corners[:, [0, 2]].max() >= w
                         or corners[:, [1, 3]].max() >= h):
        raise ValueError(f"corner cells lie off the {h}x{w} grid")
    xs = np.unique(corners[:, [0, 2]])
    ys = np.unique(corners[:, [1, 3]])

    def cell_map(values, n):
        m = np.searchsorted(values, np.arange(n), side="left")
        return torch.from_numpy(np.where(m < len(values), m, -1)
                                .astype(np.int32))
    lat = np.stack([np.searchsorted(xs, corners[:, 0]),
                    np.searchsorted(ys, corners[:, 1]),
                    np.searchsorted(xs, corners[:, 2]),
                    np.searchsorted(ys, corners[:, 3])], 1).astype(np.int32)
    return AnchorLattice(torch.from_numpy(corners), cell_map(ys, h),
                         cell_map(xs, w), torch.from_numpy(lat),
                         (len(ys), len(xs)))


def anchors_mask_lattice_plain(coords_zyx: torch.Tensor,
                               lattice: AnchorLattice,
                               threshold: float) -> torch.Tensor:
    """K9's steps in plain PyTorch: the voxel counts scattered into the
    [B, LY, LX] lattice, its inclusive integral, the 4-corner sum of each
    anchor at its lattice corners as float32 against the threshold. Equal
    to :func:`anchors_mask_plain` bit for bit."""
    ly, lx = lattice.shape
    b = coords_zyx.shape[0]
    c = coords_zyx.to(torch.int64)
    my = lattice.ymap.to(torch.int64)[c[..., 1].clamp(min=0)]
    mx = lattice.xmap.to(torch.int64)[c[..., 2].clamp(min=0)]
    ok = (c[..., 0] >= 0) & (my >= 0) & (mx >= 0)
    base = torch.arange(b, device=c.device)[:, None] * (ly * lx)
    flat = torch.where(ok, base + my * lx + mx, b * ly * lx).reshape(-1)
    dense = torch.zeros(b * ly * lx + 1, dtype=torch.int64, device=c.device)
    dense.index_add_(0, flat, torch.ones_like(flat))
    integral = dense[:b * ly * lx].view(b, ly, lx).cumsum(1).cumsum(2)
    x0, y0, x1, y1 = lattice.lattice_corners.to(torch.int64).unbind(1)
    area = (integral[:, y1, x1] - integral[:, y0, x1]
            - integral[:, y1, x0] + integral[:, y0, x0])
    return area.to(torch.float32) > threshold


def anchors_mask(coords_zyx: torch.Tensor, lattice: AnchorLattice,
                 threshold: float) -> torch.Tensor:
    """BEV occupancy prefilter on the coords' device.

    coords_zyx: [B, V, 3] int32 (-1 rows = padding); lattice: the corner
    table's :class:`AnchorLattice` on the coords' device. Returns [B, A]
    bool: anchors whose footprint covers more than `threshold` voxels, in
    the anchor order (class -> y -> x -> rot). K9 on the card; CPU coords
    take :func:`anchors_mask_plain` on the grid corners.
    """
    if coords_zyx.device.type == "cpu":
        return anchors_mask_plain(coords_zyx, lattice.corners,
                                  lattice.grid_hw, threshold)
    cuda.check_cuda("coords_zyx", coords_zyx, torch.int32, 3)
    for name in ("ymap", "xmap"):
        cuda.check_cuda(name, getattr(lattice, name), torch.int32, 1)
    lc = lattice.lattice_corners
    cuda.check_cuda("lattice_corners", lc, torch.int32, 2)
    b, v, three = coords_zyx.shape
    a = lc.shape[0]
    if three != 3 or lc.shape[1] != 4:
        raise ValueError(f"coords {tuple(coords_zyx.shape)} / lattice "
                         f"corners {tuple(lc.shape)} are not [B, V, 3] / "
                         f"[A, 4]")
    dev = coords_zyx.device
    if any(t.device != dev for t in (lattice.ymap, lattice.xmap, lc)):
        raise ValueError("the lattice tables must be on the coords' device")
    if lc.data_ptr() % 16:
        raise ValueError("lattice corners must be 16-byte aligned")
    (h, w), (ly, lx) = lattice.grid_hw, lattice.shape
    with torch.cuda.device(dev):
        cells = torch.empty((b, ly, lx), dtype=torch.int32, device=dev)
        mask = torch.empty((b, a), dtype=torch.bool, device=dev)
        _K9.launch(coords_zyx.data_ptr(), b, v, lattice.ymap.data_ptr(), h,
                   lattice.xmap.data_ptr(), w, lc.data_ptr(), a, ly, lx,
                   float(threshold), cells.data_ptr(), mask.data_ptr())
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

def serving_lattice(cfg: SASSDConfig, anchors_bv: np.ndarray) -> AnchorLattice:
    """The config's anchor corner table and its K9 lattice, on the CPU."""
    return anchor_lattice(anchor_corner_indices(
        anchors_bv, cfg.voxel.voxel_size, cfg.voxel.point_cloud_range,
        cfg.voxel.grid_size),
        (int(cfg.voxel.grid_size[1]), int(cfg.voxel.grid_size[0])))


def batch_from_points(points: torch.Tensor, n_points: torch.Tensor,
                      lattice: AnchorLattice,
                      cfg: SASSDConfig) -> Dict[str, torch.Tensor]:
    """Voxelize + anchors mask on the points' device.

    points [B, P, F] float32 (zero padded), n_points [B] int32, lattice
    the config's :func:`serving_lattice` on the same device. Returns the
    test batch (voxels, num_points, coords, anchors_mask) with no
    ``plan_*`` keys, so ``Detector.forward_spine`` builds the rulebook on
    the device.
    """
    with record_function("voxelize"):
        voxels, coords, nums = voxelize(points, n_points, cfg.voxel)
    with record_function("anchors_mask"):
        mask = anchors_mask(coords, lattice, cfg.data.anchor_area_threshold)
    return dict(voxels=voxels, num_points=nums, coords=coords,
                anchors_mask=mask)


def init_plan_carry(cfg: SASSDConfig, device) -> Dict[str, torch.Tensor]:
    """The carry of persistent-plan serving on `device`: the [1, D*H*W]
    int32 index map of each plan-building level (0-2), filled with -1
    once, and the level's previous keys, [1, cap] INVALID_KEY (no previous
    scan). The maps are updated in place by each scan's
    :func:`plans_from_carry`."""
    shapes = level_shapes(cfg.sparse_shape)
    caps = cfg.caps.level_caps
    carry = {}
    for lvl in range(3):
        total = int(np.prod(shapes[lvl]))
        carry[f"map{lvl}"] = torch.full((1, total), -1, dtype=torch.int32,
                                        device=device)
        carry[f"keys{lvl}"] = torch.full((1, caps[lvl]), sp.INVALID_KEY,
                                         dtype=torch.int32, device=device)
    return carry


def plans_from_carry(coords0: torch.Tensor, carry: Dict[str, torch.Tensor],
                     cfg: SASSDConfig
                     ) -> Tuple[Dict[str, torch.Tensor],
                                Dict[str, torch.Tensor]]:
    """One scan's rulebook through the carried index maps.

    coords0: [cap0, 3] int32 zyx level-0 coords of one sample (-1 rows =
    padding). K7 makes levels 1-3 (the downsample reads keys only); then
    one K17 call updates the three carried maps from the previous scan's
    keys to this scan's, and one call of K6's plans resolves the
    submanifold plans (scale 1) and the stride plans (scale 2) through
    them: five C calls a scan. Returns (plans, carry): subm0..2,
    stride1..3 [1, 27, capL] int32 and coords1..3 [1, capL, 3] int32, the
    per-scan device rulebook's plans bit for bit, and the carry with the
    same maps, now updated in place, and this scan's keys."""
    shapes = level_shapes(cfg.sparse_shape)
    caps = cfg.caps.level_caps
    keys = [sp.coords_to_keys(coords0[None], shapes[0])]
    plans = {}
    for lvl in (1, 2, 3):
        keys.append(sp.downsample_keys(keys[-1], shapes[lvl - 1], caps[lvl]))
        plans[f"coords{lvl}"] = sp.keys_to_coords(keys[lvl], shapes[lvl])
    maps = sp.update_index_maps([carry[f"map{lvl}"] for lvl in range(3)],
                                [carry[f"keys{lvl}"] for lvl in range(3)],
                                keys[:3], shapes[:3])
    plans.update(sp.rulebook_plans(keys, shapes, maps))
    new_carry = {}
    for lvl in range(3):
        new_carry[f"map{lvl}"] = maps[lvl]
        new_carry[f"keys{lvl}"] = keys[lvl]
    return plans, new_carry


def make_serving_step(cfg: SASSDConfig, anchors: np.ndarray,
                      anchors_bv: np.ndarray, device,
                      persistent_plans: bool = False) -> Callable:
    """Returns step(model, batch) -> detections on `device` (not synced),
    where batch is dict(points [B, P, F] f32, n_points [B] int32) in
    numpy; the upload is inside the step. The mask's lattice tables and the
    anchors are built and uploaded once, here. The step puts the model in
    eval mode and runs without autograd.

    persistent_plans (batch 1 only, one scan stream): the step is
    step(model, carry, batch) -> (detections, carry), with the carry from
    :func:`init_plan_carry`, whose maps it updates in place; the rulebook
    is :func:`plans_from_carry`'s, handed to the model as the batch's
    ``plan_*`` keys. Detections are those of the per-scan step. A batch
    of other than one scan raises ValueError."""
    check_supported(cfg)
    lattice = serving_lattice(cfg, anchors_bv).to(device)
    anchors_t = torch.from_numpy(np.asarray(anchors, np.float32)).to(device)

    def forward(model: Detector, batch: Dict[str, np.ndarray],
                carry: Optional[Dict[str, torch.Tensor]] = None):
        model.eval()
        with torch.inference_mode():
            points, n_points = (torch.from_numpy(np.ascontiguousarray(
                batch[k])).to(device) for k in ("points", "n_points"))
            full = batch_from_points(points, n_points, lattice, cfg)
            if carry is not None:
                with record_function("rulebook"):
                    plans, carry = plans_from_carry(full["coords"][0], carry,
                                                    cfg)
                full.update({f"plan_{k}": v for k, v in plans.items()})
            # serving ignores the parallel strategy, as in the JAX package
            return model.forward_test(full, anchors_t, replicated=True), carry

    if persistent_plans:
        def step_p(model: Detector, carry: Dict[str, torch.Tensor],
                   batch: Dict[str, np.ndarray]):
            if np.shape(batch["points"])[0] != 1:
                raise ValueError("persistent_plans serving is batch_size=1 "
                                 "only (one carry per scan stream)")
            return forward(model, batch, carry)
        return step_p

    def step(model: Detector, batch: Dict[str, np.ndarray]):
        return forward(model, batch)[0]
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
