"""Rotated BEV IoU, rotated 3D IoU and rotated NMS (kernel K2).

BEV box layout: [x, y, w, l, yaw] (center format; w = local-x extent).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from sassd_tpu_torch.ops import cuda
from sassd_tpu_torch.ops.riou_kernel import rotate_overlap

_K2 = cuda.Kernel("sassd_nms_keep",
                  [cuda.P, cuda.P, cuda.I, cuda.F, cuda.P, cuda.P])
# K2's sweep is one warp holding the removed bits of the boxes in
# registers, at most 4 words of 64 boxes a lane
K2_MAX_BOXES = 32 * 64 * 4


def boxes3d_to_bev5(boxes3d: torch.Tensor) -> torch.Tensor:
    """[..., 7] 3D boxes -> [..., 5] BEV boxes (x, y, w, l, yaw)."""
    return boxes3d[..., [0, 1, 3, 4, 6]]


def rotate_iou_bev(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise rotated-BEV IoU. [N,5] x [M,5] -> [N,M]."""
    return rotate_overlap(boxes1, boxes2, criterion=-1)


def rotate_iou_3d(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise 3D IoU of [N,7] x [M,7] boxes (z = bottom): the rotated BEV
    overlap (K1, criterion 2) times the height overlap, over the union
    volume (RotateIou3dSimilarity). Not differentiable."""
    inter_bev = rotate_overlap(boxes3d_to_bev5(boxes1).contiguous(),
                               boxes3d_to_bev5(boxes2).contiguous(), 2)
    amin = boxes1[:, 2][:, None]
    amax = (boxes1[:, 2] + boxes1[:, 5])[:, None]
    bmin = boxes2[:, 2][None, :]
    bmax = (boxes2[:, 2] + boxes2[:, 5])[None, :]
    inter_h = torch.clamp(torch.minimum(amax, bmax)
                          - torch.maximum(amin, bmin), min=0.0)
    inter = inter_bev * inter_h
    vol1 = (boxes1[:, 3] * boxes1[:, 4] * boxes1[:, 5])[:, None]
    vol2 = (boxes2[:, 3] * boxes2[:, 4] * boxes2[:, 5])[None, :]
    return inter / torch.clamp(vol1 + vol2 - inter, min=1e-7)


def nms_keep_plain(iou: torch.Tensor, keep0: torch.Tensor,
                   iou_threshold: float) -> torch.Tensor:
    """Plain PyTorch version of K2: exact greedy keep flags.

    With the boxes score-sorted, greedy keep is the unique fixpoint of
    G(K)_i = keep0_i and no j < i with K_j and iou[i, j] > thr. Iterating G
    from keep0 fixes box i by round (depth of i in the suppression chain),
    so the loop ends after at most N rounds.
    """
    n = iou.shape[0]
    sup = torch.tril(iou > iou_threshold, diagonal=-1)        # [i, j], j < i
    keep = keep0
    for _ in range(n + 1):
        new = keep0 & ~torch.any(sup & keep[None, :], dim=1)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def nms_keep(iou: torch.Tensor, keep0: torch.Tensor,
             iou_threshold: float) -> torch.Tensor:
    """Greedy NMS keep flags over score-sorted boxes.

    iou: [N, N] float32, iou[i, j] with box i as the overlap's subject;
    keep0: [N] bool candidates. Box i is dropped when a kept j < i has
    iou[i, j] > thr. Returns [N] bool. On the card N <= K2_MAX_BOXES.
    """
    if iou.device.type == "cpu":
        return nms_keep_plain(iou, keep0, iou_threshold)
    cuda.check_cuda("iou", iou, torch.float32, 2)
    cuda.check_cuda("keep0", keep0, torch.bool, 1)
    n = keep0.shape[0]
    if n > K2_MAX_BOXES:
        raise ValueError(f"nms_keep takes at most {K2_MAX_BOXES} boxes on "
                         f"the card, got {n}; lower test.nms_pre")
    if iou.shape != (n, n):
        raise ValueError(f"iou {tuple(iou.shape)} does not match keep0 [{n}]")
    blocks = -(-n // 64)
    with torch.cuda.device(iou.device):
        # scratch: the bitmask's upper triangle of 64-box blocks (block w:
        # 64 rows of blocks - w words), then the candidate word of each
        scratch = torch.empty((32 * blocks * (blocks + 1) + blocks,),
                              dtype=torch.int64, device=iou.device)
        keep = torch.empty((n,), dtype=torch.bool, device=iou.device)
        _K2.launch(iou.data_ptr(), keep0.data_ptr(), n, float(iou_threshold),
                   scratch.data_ptr(), keep.data_ptr())
    return keep


def rotate_nms(boxes_bev: torch.Tensor, scores: torch.Tensor,
               iou_threshold: float, valid: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact greedy rotated NMS.

    Args:
      boxes_bev: [N, 5] center-format BEV boxes.
      scores: [N] detection scores.
      iou_threshold: suppress a box if IoU > thr with a kept higher-scored box.
      valid: optional [N] bool; invalid boxes are never kept.
    Returns:
      (order [N]: indices by descending score, ties in index order;
       keep [N] bool aligned with `order`).
    """
    if valid is not None:
        scores = torch.where(valid, scores, -torch.inf)
    order = torch.argsort(-scores, stable=True)
    boxes_sorted = boxes_bev[order].float().contiguous()
    keep0 = torch.isfinite(scores[order])
    iou = rotate_iou_bev(boxes_sorted, boxes_sorted)                    # K1
    return order, nms_keep(iou, keep0, iou_threshold)                   # K2
