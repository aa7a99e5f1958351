"""Anchor-based rotated SSD head and guided-anchor selection (inference).

Predictions flatten in (class, y, x, anchor_rot) order, the order of the
anchors from ``data.kitti.build_anchors``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from sassd_tpu_torch.core import boxes as box_ops
from . import layers as L


class HeadOutputs(NamedTuple):
    box_preds: torch.Tensor   # [B, A, 7]
    cls_preds: torch.Tensor   # [B, A, num_class]
    dir_preds: torch.Tensor   # [B, A, 2]


class GuidedAnchors(NamedTuple):
    boxes: torch.Tensor       # [B, K, 7] decoded candidate boxes
    labels: torch.Tensor      # [B, K] int64 class indices (0-based)
    valid: torch.Tensor       # [B, K] bool
    truncated: torch.Tensor   # [B] passing candidates dropped by the cap


def _flatten(pred: torch.Tensor, num_class: int, per_anchor: int,
             anchors_per_loc: int) -> torch.Tensor:
    """[B,H,W, ncls*apl*d] -> [B, ncls*H*W*apl, d] (class, y, x, anchor)."""
    b, h, w, _ = pred.shape
    pred = pred.reshape(b, h, w, num_class, anchors_per_loc, per_anchor)
    pred = pred.permute(0, 3, 1, 2, 4, 5)
    return pred.reshape(b, num_class * h * w * anchors_per_loc, per_anchor)


class SSDHead(nn.Module):
    """Three 1x1 convs (cls / box / dir), run as one conv over their
    concatenated output channels."""

    def __init__(self, gen: torch.Generator, num_output_filters: int,
                 num_class: int, num_anchor_per_loc: int,
                 box_code_size: int = 7):
        super().__init__()
        self.num_class = num_class
        self.anchors_per_loc = num_anchor_per_loc
        self.box_code_size = box_code_size
        npl = num_anchor_per_loc * num_class
        c = num_output_filters
        self.conv_cls = L.Conv2d(gen, 1, c, npl * num_class, bias=True)
        self.conv_box = L.Conv2d(gen, 1, c, npl * box_code_size, bias=True)
        self.conv_dir = L.Conv2d(gen, 1, c, npl * 2, bias=True)

    def forward(self, x: torch.Tensor) -> HeadOutputs:
        """[B, H, W, C] BEV map -> flattened box/cls/dir predictions."""
        convs = (self.conv_box, self.conv_cls, self.conv_dir)
        w = torch.cat([m.w for m in convs], dim=-1)
        b = torch.cat([m.b for m in convs], dim=-1)
        y = L.conv2d(x, w, b)                                   # NHWC view
        npl = self.num_class * self.anchors_per_loc
        nb, nc = npl * self.box_code_size, npl * self.num_class
        apl = self.anchors_per_loc
        return HeadOutputs(
            _flatten(y[..., :nb], self.num_class, self.box_code_size, apl),
            _flatten(y[..., nb:nb + nc], self.num_class, self.num_class, apl),
            _flatten(y[..., nb + nc:], self.num_class, 2, apl))


def top_k_stable(x: torch.Tensor, k: int):
    """Top-k along the last axis with ties in index order (lax.top_k's
    order): a stable descending sort."""
    idx = torch.argsort(-x, dim=-1, stable=True)[..., :k]
    return torch.gather(x, -1, idx), idx


def get_guided_anchors(outs: HeadOutputs, anchors: torch.Tensor,
                       anchors_mask: torch.Tensor, *, num_class: int,
                       thr: float, cap: int) -> GuidedAnchors:
    """Decode + score threshold + top-`cap` candidates per sample.

    Candidates pass (score > thr) & anchors_mask; a box whose yaw sign
    disagrees with the direction head is turned by pi.
    """
    decoded = box_ops.second_box_decode(outs.box_preds, anchors[None])
    scores = torch.sigmoid(outs.cls_preds)                      # [B, A, ncls]
    if num_class == 1:
        top_scores = scores[..., 0]
        top_labels = torch.zeros_like(top_scores, dtype=torch.int64)
    else:
        top_scores, top_labels = torch.max(scores, dim=-1)

    sel = (top_scores > thr) & anchors_mask
    ranked = torch.where(sel, top_scores, -torch.inf)
    truncated = torch.clamp(sel.sum(dim=1) - cap, min=0)
    top_vals, top_idx = top_k_stable(ranked, cap)               # [B, cap]
    valid = torch.isfinite(top_vals)

    boxes = torch.gather(decoded, 1, top_idx[..., None].expand(-1, -1, 7))
    labels = torch.gather(top_labels, 1, top_idx)
    dirs = torch.gather(outs.dir_preds, 1,
                        top_idx[..., None].expand(-1, -1, 2))
    dir_labels = torch.argmax(dirs, dim=-1)

    opp = (boxes[..., -1] > 0) != (dir_labels > 0)
    yaw = boxes[..., -1] + torch.where(opp, np.pi, 0.0)
    boxes = torch.cat([boxes[..., :-1], yaw[..., None]], dim=-1)
    boxes = torch.where(valid[..., None], boxes, 0.0)
    return GuidedAnchors(boxes, labels, valid, truncated)
