"""KITTI calibration, label and point-cloud I/O (host side, numpy).

A copy of the JAX package's ``data/calib.py``: label lines, the
calibration file, and the velodyne / rect-camera / image projections.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class Object3d:
    """One KITTI label line."""
    type: str
    truncation: float
    occlusion: int
    alpha: float
    box2d: np.ndarray          # [4] xmin ymin xmax ymax
    h: float
    w: float
    l: float
    t: np.ndarray              # [3] camera-frame location (bottom center)
    ry: float
    score: float = 1.0

    @property
    def box3d(self) -> np.ndarray:
        """[7] camera box (x, y, z, w, l, h, ry)."""
        return np.array([*self.t, self.w, self.l, self.h, self.ry], np.float32)


def parse_label_line(line: str) -> Object3d:
    d = line.strip().split(" ")
    vals = [float(x) for x in d[1:]]
    return Object3d(
        type=d[0], truncation=vals[0], occlusion=int(vals[1]), alpha=vals[2],
        box2d=np.array(vals[3:7], np.float32),
        h=vals[7], w=vals[8], l=vals[9],
        t=np.array(vals[10:13], np.float32), ry=vals[13],
        score=vals[14] if len(vals) > 14 else 1.0)


def read_label(path) -> List[Object3d]:
    with open(path) as f:
        return [parse_label_line(ln) for ln in f if ln.strip()]


def read_lidar(path) -> np.ndarray:
    return np.fromfile(str(path), dtype=np.float32).reshape(-1, 4)


class Calibration:
    """KITTI calib file: P2/P3 [3,4], R0 [3,3], V2C [3,4]."""

    def __init__(self, calib_file=None, *, P2=None, P3=None, R0=None, V2C=None):
        if calib_file is not None:
            mats = self._read(calib_file)
            P2 = mats["P2"].reshape(3, 4)
            P3 = mats.get("P3", mats["P2"]).reshape(3, 4)
            R0 = mats["R0_rect"].reshape(3, 3)
            V2C = mats["Tr_velo_to_cam"].reshape(3, 4)
        self.P2 = np.asarray(P2, np.float64)
        self.P3 = np.asarray(P3, np.float64)
        self.R0 = np.asarray(R0, np.float64)
        self.V2C = np.asarray(V2C, np.float64)
        self.C2V = self._inverse_rigid(self.V2C)
        self.c_u, self.c_v = self.P2[0, 2], self.P2[1, 2]
        self.f_u, self.f_v = self.P2[0, 0], self.P2[1, 1]
        self.b_x = self.P2[0, 3] / (-self.f_u)
        self.b_y = self.P2[1, 3] / (-self.f_v)

    @staticmethod
    def _read(path):
        out = {}
        with open(path) as f:
            for line in f:
                if ":" not in line:
                    continue
                k, v = line.split(":", 1)
                out[k.strip()] = np.array(
                    [float(x) for x in v.split()], np.float64)
        return out

    @staticmethod
    def _inverse_rigid(tr):
        inv = np.zeros_like(tr)
        inv[:3, :3] = tr[:3, :3].T
        inv[:3, 3] = -tr[:3, :3].T @ tr[:3, 3]
        return inv

    # 4x4 homogeneous forms (for core.boxes camera<->lidar helpers)
    @property
    def velo2cam4(self) -> np.ndarray:
        m = np.eye(4)
        m[:3] = self.V2C
        return m

    @property
    def rect4(self) -> np.ndarray:
        m = np.eye(4)
        m[:3, :3] = self.R0
        return m


def _hom(pts):
    return np.concatenate([pts, np.ones((pts.shape[0], 1), pts.dtype)], 1)


def project_velo_to_rect(pts, calib: Calibration) -> np.ndarray:
    ref = _hom(np.asarray(pts, np.float64)) @ calib.V2C.T
    return (ref @ calib.R0.T).astype(np.float32)


def project_rect_to_velo(pts, calib: Calibration) -> np.ndarray:
    ref = np.asarray(pts, np.float64) @ np.linalg.inv(calib.R0).T
    return (_hom(ref) @ calib.C2V.T).astype(np.float32)


def project_rect_to_image(pts, calib: Calibration) -> np.ndarray:
    """[..., 3] rect-camera points -> [..., 2] image coords."""
    pts = np.asarray(pts, np.float64)
    flat = pts.reshape(-1, 3)
    uvw = _hom(flat) @ calib.P2.T
    uv = uvw[:, :2] / uvw[:, 2:3]
    return uv.reshape(*pts.shape[:-1], 2).astype(np.float32)


def remove_outside_points(points, calib: Calibration, image_shape
                          ) -> np.ndarray:
    """Frustum crop: keep points projecting into the image with z_cam > 0
    (the reduced-cloud semantics of KITTI's velodyne_reduced)."""
    rect = project_velo_to_rect(points[:, :3], calib)
    uv = project_rect_to_image(rect, calib)
    h, w = image_shape[:2]
    ok = ((uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) & (uv[:, 1] < h)
          & (rect[:, 2] > 0))
    return points[ok]
