"""Host side of the inference input: anchors, anchors mask, host plans, and
the KITTI datasets that produce test samples.

Every sample is a dict of fixed-shape numpy arrays plus a ``meta`` dict
(sample id, calibration, image shape), so a batch is a plain ``np.stack``
of the arrays and the list of metas (:func:`collate`).
"""
from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from sassd_tpu_torch.config import SASSDConfig
from sassd_tpu_torch.core import anchors as anchor_lib
from sassd_tpu_torch.ops import native
from sassd_tpu_torch.ops.voxelize import voxelize_np
from . import calib as calib_lib
from .augment import nearest_bev_np

DEFAULT_IMAGE_SHAPE = (375, 1242)


def png_shape(path) -> tuple:
    """(height, width) from a PNG header without an image library."""
    with open(path, "rb") as f:
        head = f.read(26)
    w, h = struct.unpack(">II", head[16:24])
    return (h, w)


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


def collate(samples: List[Dict]):
    """Stack fixed-shape samples into a batch; returns (batch, metas), with
    None for a sample that has no ``meta``."""
    metas = [s.get("meta") for s in samples]
    keys = [k for k in samples[0] if k != "meta"]
    return {k: np.stack([s[k] for s in samples]) for k in keys}, metas


class KittiDataset:
    """KITTI 3D detection test samples from the standard directory layout
    (``velodyne[_reduced]``, ``calib``, ``label_2``, ``image_2``). The
    training samples (augmentation, targets) are not carried yet."""

    def __init__(self, cfg: SASSDConfig, root: str, split_file: str,
                 with_label: bool = True):
        self.cfg = cfg
        self.root = Path(root)
        self.with_label = with_label
        with open(split_file) as f:
            self.sample_ids = [int(x) for x in f.read().split()]
        self.anchors, self.anchors_bv = build_anchors(cfg)

    def __len__(self):
        return len(self.sample_ids)

    def _lidar_path(self, sid):
        p = self.root / "velodyne_reduced" / f"{sid:06d}.bin"
        if not p.exists():
            p = self.root / "velodyne" / f"{sid:06d}.bin"
        return p

    def _image_shape(self, sid):
        p = self.root / "image_2" / f"{sid:06d}.png"
        return png_shape(p) if p.exists() else DEFAULT_IMAGE_SHAPE

    def load_raw(self, idx: int):
        sid = self.sample_ids[idx]
        points = calib_lib.read_lidar(self._lidar_path(sid))
        calib = calib_lib.Calibration(self.root / "calib" / f"{sid:06d}.txt")
        objects = []
        label_path = self.root / "label_2" / f"{sid:06d}.txt"
        if self.with_label and label_path.exists():
            objects = calib_lib.read_label(label_path)
        return sid, points, calib, objects

    def load_points(self, idx: int):
        """(raw points, meta): the device-resident serving input
        (serve.PointsView wraps this)."""
        sid, points, calib, _ = self.load_raw(idx)
        return points, dict(sample_idx=sid, calib=calib,
                            img_shape=self._image_shape(sid))

    def __getitem__(self, idx: int) -> Dict:
        points, meta = self.load_points(idx)
        sample = prepare_scan(self.cfg, points, self.anchors_bv)
        sample["meta"] = meta
        return sample


class RawScanDataset:
    """Inference over a directory of raw .bin scans: no labels, one shared
    calibration (the default synthetic one unless a file is given)."""

    def __init__(self, cfg: SASSDConfig, scan_dir: str,
                 calib_file: Optional[str] = None,
                 img_shape=DEFAULT_IMAGE_SHAPE):
        self.cfg = cfg
        self.files = sorted(Path(scan_dir).glob("*.bin"))
        if calib_file is not None:
            self.calib = calib_lib.Calibration(calib_file)
        else:
            from .synthetic import default_calib  # synthetic imports kitti
            self.calib = default_calib()
        self.img_shape = img_shape
        self.anchors, self.anchors_bv = build_anchors(cfg)

    def __len__(self):
        return len(self.files)

    def load_points(self, idx):
        points = calib_lib.read_lidar(self.files[idx])
        return points, dict(sample_idx=idx, calib=self.calib,
                            img_shape=self.img_shape)

    def __getitem__(self, idx):
        points, meta = self.load_points(idx)
        sample = prepare_scan(self.cfg, points, self.anchors_bv)
        sample["meta"] = meta
        return sample
