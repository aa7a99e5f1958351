"""Part-sensitive warping head (confidence rescoring) and final NMS.

A part-sensitive score map (3x3 conv -> BN -> ReLU -> 1x1 conv, K =
num_parts channels) is sampled at a rotated per-box lattice, one part per
lattice point; the mean of the K samples is the rescored confidence
(kernel K3; K3b its gradient in the map and the boxes). The rescored boxes
then go through rotated NMS (K1 + K2); in training, the scores' focal loss
is assigned by rotated 3D IoU (K1).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from sassd_tpu_torch.core import losses as loss_ops
from sassd_tpu_torch.core import riou
from sassd_tpu_torch.core import targets as target_ops
from sassd_tpu_torch.ops import warp
from . import layers as L
from .ssd_head import top_k_stable


class PSWarpHead(nn.Module):

    def __init__(self, gen: torch.Generator, in_channels: int,
                 num_class: int = 1, num_parts: int = 28):
        super().__init__()
        out_channels = num_class * num_parts
        self.conv0 = L.Conv2d(gen, 3, in_channels, out_channels)
        self.conv1 = L.Conv2d(gen, 1, out_channels, out_channels)
        self.bn0 = L.BatchNorm(out_channels)

    def forward(self, conv6: torch.Tensor, boxes: torch.Tensor,
                valid: torch.Tensor, *,
                window_size: Tuple[int, int] = (4, 7),
                grid_offsets: Tuple[float, float] = (0.0, 40.0),
                featmap_stride: float = 0.4) -> torch.Tensor:
        """conv6 [B,H,W,C], boxes [B,K,7], valid [B,K] -> scores [B,K]."""
        x = self.conv0(conv6.permute(0, 3, 1, 2))
        x = L.relu(self.bn0(x, dim=1))
        x = self.conv1(x)                                       # [B,K,H,W]
        return warp.pswarp_score(x, boxes.float().contiguous(), valid,
                                 window_size, grid_offsets,
                                 1.0 / featmap_stride)


def pswarp_labels(boxes: torch.Tensor, valid: torch.Tensor,
                  gt_boxes: torch.Tensor, gt_valid: torch.Tensor, *,
                  pos_iou_thr: float = 0.7,
                  neg_iou_thr: float = 0.7) -> torch.Tensor:
    """[B, K] assignment of the candidates to the GTs by rotated 3D IoU:
    -1 ignore, 0 negative, 1 positive."""
    return torch.stack([target_ops.create_targets(
        boxes[i], gt_boxes[i], gt_valid[i],
        target_ops.rotate_iou3d_similarity, pos_iou_thr, neg_iou_thr,
        anchors_mask=valid[i], encode=False).labels
        for i in range(boxes.shape[0])])


def pswarp_loss(scores: torch.Tensor, labels: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
    """Rescoring focal loss over the [B, K] scores given pswarp_labels,
    normalised by the positives of the whole batch."""
    b = scores.shape[0]
    cared = labels >= 0
    positives = labels > 0
    cls_weights = (cared & ((labels == 0) | positives)).to(torch.float32)
    pos_norm = torch.clamp(torch.sum(positives.to(torch.float32)), min=1.0)
    cls_targets = torch.where(cared, labels, 0).to(torch.float32)
    loss = loss_ops.sigmoid_focal_loss(scores, cls_targets,
                                       cls_weights / pos_norm) / b
    return dict(loss_cls=loss)


def rescore_and_nms(boxes: torch.Tensor, scores: torch.Tensor,
                    labels: torch.Tensor, valid: torch.Tensor, *,
                    score_thr: float = 0.3, nms_iou_thr: float = 0.1,
                    max_det: int = 100, nms_pre: int = 2000):
    """sigmoid -> score threshold -> top nms_pre -> rotated NMS -> first
    max_det kept boxes in score order.

    Returns (det_boxes [B,D,7], det_scores [B,D], det_labels [B,D],
    det_valid [B,D]).
    """
    probs = torch.sigmoid(scores)
    keep_in = valid & (probs > score_thr)
    out = []
    for bx, sc, lb, ok in zip(boxes, probs, labels, keep_in):
        if nms_pre < sc.shape[0]:
            vals, sel = top_k_stable(torch.where(ok, sc, -1.0), nms_pre)
            bx, lb, sc, ok = bx[sel], lb[sel], sc[sel], ok[sel] & (vals > 0)
        order, keep = riou.rotate_nms(riou.boxes3d_to_bev5(bx), sc,
                                      nms_iou_thr, valid=ok)
        n = keep.shape[0]
        rank = torch.where(keep, torch.arange(n, device=keep.device), n)
        take = torch.argsort(rank, stable=True)[:max_det]
        idx = order[take]
        dvalid = keep[take]
        out.append((bx[idx], sc[idx] * dvalid, lb[idx], dvalid))
    db, ds, dl, dv = (torch.stack(t) for t in zip(*out))
    return db, torch.where(dv, ds, 0.0), dl, dv
