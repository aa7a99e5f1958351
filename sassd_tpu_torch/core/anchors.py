"""3D anchor grid generation (host numpy).

A dense grid of anchor centres (stride/offset placement) crossed with
anchor sizes and yaw rotations, in [z, y, x, size, rot] nesting order.
"""
from __future__ import annotations

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
