"""Anchor-GT target assignment over padded GT sets, one sample at a time.

Rules (the JAX package's ``core/targets.py``):
  * per-anchor argmax GT; positive if max IoU >= matched_threshold;
  * per-GT force match: every anchor tied at a GT's best overlap is
    positive, unless that best overlap is <= 0;
  * negative if max IoU < unmatched_threshold; a force match wins;
  * anchors outside `anchors_mask` are "don't care" (-1), targets 0.
The similarity is a discrete decision and carries no gradient.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from . import boxes as box_ops
from . import riou


class TargetAssignment(NamedTuple):
    labels: torch.Tensor        # [A] int64: -1 ignore / 0 negative / >0 class
    bbox_targets: torch.Tensor  # [A, 7] residuals (0 where not positive)
    max_overlap: torch.Tensor   # [A] best IoU with any valid GT


def nearest_iou_similarity(anchors, gt_boxes):
    return box_ops.nearest_iou_similarity(anchors, gt_boxes)


def rotate_iou3d_similarity(anchors, gt_boxes):
    return riou.rotate_iou_3d(anchors, gt_boxes)


def rotate_iou2d_similarity(anchors, gt_boxes):
    """Rotated BEV IoU (RotateIou2dSimilarity): K1 at criterion -1."""
    return riou.rotate_iou_bev(riou.boxes3d_to_bev5(anchors),
                               riou.boxes3d_to_bev5(gt_boxes))


def make_distance_similarity(dist_norm: float, with_rotation: bool = False,
                             rot_alpha: float = 0.5) -> Callable:
    """Negated-distance similarity (DistanceSimilarity):

        1 - min(d^2/dist_norm, dist_norm)                 (no rotation)
        1 - (1-a)*min(d^2/dist_norm, dist_norm) - a*|sin(dth)|   (rotated)

    gated to 0 outside the |dx|,|dy| <= dist_norm window.
    """
    def similarity(anchors, gt_boxes):
        dx = anchors[:, None, 0] - gt_boxes[None, :, 0]
        dy = anchors[:, None, 1] - gt_boxes[None, :, 1]
        inside = (torch.abs(dx) <= dist_norm) & (torch.abs(dy) <= dist_norm)
        dn = torch.clamp(
            (dx * dx + dy * dy) / dist_norm, max=dist_norm)
        if with_rotation:
            dr = torch.abs(torch.sin(anchors[:, None, 6]
                                     - gt_boxes[None, :, 6]))
            sim = 1.0 - (1.0 - rot_alpha) * dn - rot_alpha * dr
        else:
            sim = 1.0 - dn
        return torch.where(inside, sim, 0.0)

    return similarity


SIMILARITY_FNS = {
    "NearestIouSimilarity": nearest_iou_similarity,
    "RotateIou3dSimilarity": rotate_iou3d_similarity,
    "RotateIou2dSimilarity": rotate_iou2d_similarity,
    # the JAX package's default dist_norm (second.pytorch's pedestrian and
    # cyclist recipe)
    "DistanceSimilarity": make_distance_similarity(dist_norm=1.0),
}


def create_targets(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_valid: torch.Tensor, similarity_fn: Callable,
                   matched_threshold: float, unmatched_threshold: float,
                   anchors_mask: Optional[torch.Tensor] = None,
                   gt_classes: Optional[torch.Tensor] = None,
                   encode: bool = True) -> TargetAssignment:
    """Assign one sample's padded GTs to its anchors.

    anchors [A, 7]; gt_boxes [G, 7]; gt_valid [G] bool; anchors_mask [A]
    bool (default all); gt_classes [G] 1-based ids (default all 1).
    encode=False skips the residual targets (zeros), for callers that read
    only the labels.
    """
    a, g = anchors.shape[0], gt_boxes.shape[0]
    dev = anchors.device
    if gt_classes is None:
        gt_classes = torch.ones((g,), dtype=torch.int64, device=dev)
    if anchors_mask is None:
        anchors_mask = torch.ones((a,), dtype=torch.bool, device=dev)
    with torch.no_grad():
        overlap = similarity_fn(anchors.detach(), gt_boxes.detach())
    pair_ok = anchors_mask[:, None] & gt_valid[None, :]
    overlap = torch.where(pair_ok, overlap, -1.0)

    anchor_max, anchor_argmax = torch.max(overlap, dim=1)
    gt_max = torch.max(overlap, dim=0).values
    gt_max = torch.where(gt_max <= 0.0, -2.0, gt_max)
    force = pair_ok & (overlap == gt_max[None, :])
    fg = torch.any(force, dim=1) | (anchor_max >= matched_threshold)
    neg = anchor_max < unmatched_threshold

    cls = gt_classes[anchor_argmax].to(torch.int64)
    labels = torch.where(fg, cls, torch.where(neg, 0, -1))
    labels = torch.where(anchors_mask, labels, -1)
    fg = fg & anchors_mask
    if encode:
        targets = box_ops.second_box_encode(gt_boxes[anchor_argmax], anchors)
        targets = torch.where(fg[:, None], targets, 0.0)
    else:
        targets = torch.zeros_like(anchors)
    max_overlap = torch.where(anchors_mask, torch.clamp(anchor_max, min=0.0),
                              0.0)
    return TargetAssignment(labels, targets, max_overlap)
