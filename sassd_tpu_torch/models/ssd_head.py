"""Anchor-based rotated SSD head, its losses, and guided-anchor selection.

Predictions flatten in (class, y, x, anchor_rot) order, the order of the
anchors from ``data.kitti.build_anchors``.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sassd_tpu_torch.core import boxes as box_ops
from sassd_tpu_torch.core import losses as loss_ops
from sassd_tpu_torch.core import targets as target_ops
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


def add_sin_difference(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Yaw channel -> sin(a)cos(b) and cos(a)sin(b): their smooth-L1
    difference penalises sin(a - b)."""
    rad1 = torch.sin(boxes1[..., -1:]) * torch.cos(boxes2[..., -1:])
    rad2 = torch.cos(boxes1[..., -1:]) * torch.sin(boxes2[..., -1:])
    return (torch.cat([boxes1[..., :-1], rad1], dim=-1),
            torch.cat([boxes2[..., :-1], rad2], dim=-1))


def head_loss(outs: HeadOutputs, anchors: torch.Tensor,
              anchors_mask: torch.Tensor, gt_boxes: torch.Tensor,
              gt_classes: torch.Tensor, gt_valid: torch.Tensor, *,
              num_class: int, matched_thresholds: Sequence[float],
              unmatched_thresholds: Sequence[float],
              similarity_fn: Callable = target_ops.nearest_iou_similarity,
              box_code_size: int = 7) -> Dict[str, torch.Tensor]:
    """RPN losses: rpn_loc_loss (smooth-L1 on sin-difference residuals),
    rpn_cls_loss (focal) and rpn_dir_loss (softmax CE of the yaw sign),
    each normalised by the positives per sample and averaged over the
    batch.

    anchors [A, 7] class-major; anchors_mask [B, A]; gt_boxes [B, G, 7];
    gt_classes [B, G] 1-based; gt_valid [B, G].
    """
    b = outs.box_preds.shape[0]
    a_cls = anchors.shape[0] // num_class
    labels_c, targets_c = [], []
    for c in range(num_class):
        sl = slice(c * a_cls, (c + 1) * a_cls)
        gv = gt_valid & (gt_classes == c + 1)
        per = [target_ops.create_targets(
            anchors[sl], gt_boxes[i], gv[i], similarity_fn,
            matched_thresholds[c], unmatched_thresholds[c],
            anchors_mask=anchors_mask[i, sl], gt_classes=gt_classes[i])
            for i in range(b)]
        labels_c.append(torch.stack([t.labels for t in per]))
        targets_c.append(torch.stack([t.bbox_targets for t in per]))
    labels = torch.stack(labels_c, 1).reshape(b, -1)              # [B, A]
    targets = torch.stack(targets_c, 1).reshape(b, -1, box_code_size)

    cared = labels >= 0
    positives = labels > 0
    negatives = labels == 0
    cls_weights = (negatives | positives).to(torch.float32)
    reg_weights = positives.to(torch.float32)
    pos_norm = torch.clamp(torch.sum(reg_weights, dim=1, keepdim=True),
                           min=1.0)
    cls_weights = cls_weights / pos_norm
    reg_weights = reg_weights / pos_norm
    cls_targets = torch.where(cared, labels, 0)
    one_hot = F.one_hot(cls_targets, num_class + 1)[..., 1:].to(torch.float32)

    box_preds, reg_targets = add_sin_difference(outs.box_preds, targets)
    loc_loss = loss_ops.smooth_l1_loss(box_preds, reg_targets,
                                       reg_weights[..., None], beta=1 / 9.0)
    cls_loss = loss_ops.sigmoid_focal_loss(outs.cls_preds, one_hot,
                                           cls_weights[..., None])
    rot_gt = targets[..., -1] + anchors[None, :, -1]
    dir_targets = (rot_gt > 0).to(torch.int64)
    dir_weights = positives.to(torch.float32)
    dir_weights = dir_weights / torch.clamp(
        torch.sum(dir_weights, dim=1, keepdim=True), min=1.0)
    dir_loss = loss_ops.softmax_cross_entropy(outs.dir_preds, dir_targets,
                                              dir_weights)
    return dict(rpn_loc_loss=loc_loss / b * 2.0,
                rpn_cls_loss=cls_loss / b * 1.0,
                rpn_dir_loss=dir_loss / b * 0.2)


def get_guided_anchors(outs: HeadOutputs, anchors: torch.Tensor,
                       anchors_mask: torch.Tensor, *, num_class: int,
                       thr: float, cap: int,
                       gt_boxes: Optional[torch.Tensor] = None,
                       gt_labels: Optional[torch.Tensor] = None,
                       gt_valid: Optional[torch.Tensor] = None
                       ) -> GuidedAnchors:
    """Decode + score threshold + top-`cap` candidates per sample.

    Candidates pass (score > thr) & anchors_mask; a box whose yaw sign
    disagrees with the direction head is turned by pi. With GT boxes
    (training) the top cap - G candidates follow the G GT boxes, labels
    and validity.
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
    k = cap if gt_boxes is None else cap - gt_boxes.shape[1]
    truncated = torch.clamp(sel.sum(dim=1) - k, min=0)
    top_vals, top_idx = top_k_stable(ranked, k)                 # [B, k]
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
    if gt_boxes is not None:
        boxes = torch.cat([gt_boxes, boxes], dim=1)
        labels = torch.cat([torch.clamp(gt_labels.to(torch.int64) - 1,
                                        min=0), labels], dim=1)
        valid = torch.cat([gt_valid, valid], dim=1)
    return GuidedAnchors(boxes, labels, valid, truncated)
