"""Camera image preprocessing (host numpy): rescale, normalize, flip, pad,
CHW; a copy of the JAX package's ``data/image.py``.

The reference's ImageTransform (``mmdet/datasets/transforms.py``) without
its mmcv / cv2 dependency. The detector never reads the image, only its
shape (2D boxes are clipped to it in the result files); this serves
raw-image workflows such as visualization.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def imrescale(img: np.ndarray, scale) -> Tuple[np.ndarray, float]:
    """Resize [H, W(, C)] to `scale` keeping the aspect ratio, bilinear
    with half-pixel centres, as float32.

    scale: a float factor, or a (max_long, max_short) bound as
    mmcv.imrescale. Returns (image, scale_factor)."""
    h, w = img.shape[:2]
    if isinstance(scale, (int, float)):
        f = float(scale)
    else:
        long_e, short_e = max(scale), min(scale)
        f = min(long_e / max(h, w), short_e / min(h, w))
    nh, nw = max(int(h * f + 0.5), 1), max(int(w * f + 0.5), 1)
    ys = np.clip((np.arange(nh) + 0.5) / f - 0.5, 0, h - 1)
    xs = np.clip((np.arange(nw) + 0.5) / f - 0.5, 0, w - 1)
    y0 = np.floor(ys).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x0 = np.floor(xs).astype(np.int64)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    im = img.astype(np.float32)
    if im.ndim == 2:
        im = im[..., None]
    top = im[y0][:, x0] * (1 - wx) + im[y0][:, x1] * wx
    bot = im[y1][:, x0] * (1 - wx) + im[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    if img.ndim == 2:
        out = out[..., 0]
    return out, f


def imnormalize(img: np.ndarray, mean, std, to_rgb: bool = True):
    """(img - mean) / std in float32, BGR -> RGB first if `to_rgb`."""
    img = img.astype(np.float32)
    if to_rgb and img.ndim == 3 and img.shape[-1] == 3:
        img = img[..., ::-1]
    return (img - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def impad_to_multiple(img: np.ndarray, divisor: int) -> np.ndarray:
    """Zero-pad the bottom and right edges to multiples of `divisor`."""
    h, w = img.shape[:2]
    ph = (h + divisor - 1) // divisor * divisor
    pw = (w + divisor - 1) // divisor * divisor
    pad = [(0, ph - h), (0, pw - w)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pad)


class ImageTransform:
    """rescale -> normalize -> (flip) -> (pad) -> CHW, returning
    (img_chw, img_shape, pad_shape, scale_factor) as the reference."""

    def __init__(self, mean=(0, 0, 0), std=(1, 1, 1), to_rgb: bool = True,
                 size_divisor: Optional[int] = None):
        self.mean, self.std = mean, std
        self.to_rgb, self.size_divisor = to_rgb, size_divisor

    def __call__(self, img: np.ndarray, scale, flip: bool = False):
        img, scale_factor = imrescale(img, scale)
        img_shape = img.shape
        img = imnormalize(img, self.mean, self.std, self.to_rgb)
        if flip:
            img = img[:, ::-1]
        if self.size_divisor is not None:
            img = impad_to_multiple(img, self.size_divisor)
        pad_shape = img.shape
        img = img[None] if img.ndim == 2 else img.transpose(2, 0, 1)
        return np.ascontiguousarray(img), img_shape, pad_shape, scale_factor


def bbox_flip(bboxes: np.ndarray, img_shape: Sequence[int]) -> np.ndarray:
    """Horizontal flip of [..., 4] (x1, y1, x2, y2) boxes in an image of
    `img_shape` (height, width, ...)."""
    w = img_shape[1]
    out = bboxes.copy()
    out[..., 0] = w - bboxes[..., 2] - 1
    out[..., 2] = w - bboxes[..., 0] - 1
    return out
