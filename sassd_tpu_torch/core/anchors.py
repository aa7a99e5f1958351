"""3D anchor grid generation (host numpy).

A dense grid of anchor centres (stride/offset or range-linspace placement)
crossed with anchor sizes and yaw rotations, in [z, y, x, size, rot]
nesting order.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


def create_anchors_3d_stride(feature_size: Sequence[int],
                             sizes=(1.6, 3.9, 1.56),
                             anchor_strides=(0.4, 0.4, 1.0),
                             anchor_offsets=(0.2, -39.8, -1.78),
                             rotations=(0.0, np.pi / 2),
                             dtype=np.float32) -> np.ndarray:
    """Dense anchor grid, stride placement.

    Args:
      feature_size: [D, H, W] (zyx) of the prediction feature map.
      sizes: flat list of anchor sizes, reshaped to [num_sizes, 3] (w, l, h).
    Returns:
      [D, H, W, num_sizes, num_rots, 7] anchors (x, y, z, w, l, h, yaw).
    """
    d, h, w = feature_size
    zc = np.arange(d, dtype=dtype) * anchor_strides[2] + anchor_offsets[2]
    yc = np.arange(h, dtype=dtype) * anchor_strides[1] + anchor_offsets[1]
    xc = np.arange(w, dtype=dtype) * anchor_strides[0] + anchor_offsets[0]
    return _assemble(zc, yc, xc, sizes, rotations, dtype)


def create_anchors_3d_range(feature_size: Sequence[int],
                            anchor_range: Sequence[float],
                            sizes=(1.6, 3.9, 1.56),
                            rotations=(0.0, np.pi / 2),
                            dtype=np.float32) -> np.ndarray:
    """Dense anchor grid, linspace placement over `anchor_range` (xmin,
    ymin, zmin, xmax, ymax, zmax); same layout as the stride grid."""
    d, h, w = feature_size
    r = np.asarray(anchor_range, dtype)
    zc = np.linspace(r[2], r[5], d, dtype=dtype)
    yc = np.linspace(r[1], r[4], h, dtype=dtype)
    xc = np.linspace(r[0], r[3], w, dtype=dtype)
    return _assemble(zc, yc, xc, sizes, rotations, dtype)


def _assemble(zc, yc, xc, sizes, rotations, dtype) -> np.ndarray:
    """Centres crossed with sizes and rotations -> [D, H, W, S, R, 7]."""
    d, h, w = len(zc), len(yc), len(xc)
    sizes = np.reshape(np.asarray(sizes, dtype), [-1, 3])
    rotations = np.asarray(rotations, dtype)
    ns, nr = sizes.shape[0], len(rotations)
    out = np.empty((d, h, w, ns, nr, 7), dtype=dtype)
    out[..., 0] = xc[None, None, :, None, None]
    out[..., 1] = yc[None, :, None, None, None]
    out[..., 2] = zc[:, None, None, None, None]
    out[..., 3:6] = sizes[None, None, None, :, None, :]
    out[..., 6] = rotations[None, None, None, None, :]
    return out


def _per_location(sizes, rotations) -> int:
    return np.asarray(sizes).reshape(-1, 3).shape[0] * len(rotations)


@dataclasses.dataclass(frozen=True)
class AnchorGeneratorStride:
    """Stride placement, called with the feature map's [D, H, W]."""
    sizes: tuple = (1.6, 3.9, 1.56)
    anchor_strides: tuple = (0.4, 0.4, 1.0)
    anchor_offsets: tuple = (0.2, -39.8, -1.78)
    rotations: tuple = (0.0, np.pi / 2)

    @property
    def num_anchors_per_localization(self) -> int:
        return _per_location(self.sizes, self.rotations)

    def __call__(self, feature_map_size) -> np.ndarray:
        return create_anchors_3d_stride(
            feature_map_size, self.sizes, self.anchor_strides,
            self.anchor_offsets, self.rotations)


@dataclasses.dataclass(frozen=True)
class AnchorGeneratorRange:
    """Range placement, called with the feature map's [D, H, W]."""
    anchor_ranges: tuple
    sizes: tuple = (1.6, 3.9, 1.56)
    rotations: tuple = (0.0, np.pi / 2)

    @property
    def num_anchors_per_localization(self) -> int:
        return _per_location(self.sizes, self.rotations)

    def __call__(self, feature_map_size) -> np.ndarray:
        return create_anchors_3d_range(
            feature_map_size, self.anchor_ranges, self.sizes, self.rotations)
