"""Box geometry: the residual (SECOND-style) box coder, nearest-BEV IoU,
and point-in-box targets (kernel K12).

Box layout: [x, y, z, w, l, h, yaw] in the lidar frame, z = bottom centre.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from sassd_tpu_torch.ops import cuda

_K12 = cuda.Kernel("sassd_points_in_boxes",
                   [cuda.P, cuda.P, cuda.P, cuda.P, cuda.I, cuda.I, cuda.I,
                    cuda.P, cuda.P])
KERNEL_SYMBOLS = {"K12": ("sassd_points_in_boxes",)}

# log-size decode clamp: exp(10) = 22026x the anchor dim, far beyond any
# physical box, small enough that exp stays finite for every anchor
SIZE_DECODE_CLIP = 10.0


def second_box_decode(encodings: torch.Tensor,
                      anchors: torch.Tensor) -> torch.Tensor:
    """[..., 7] residuals + [..., 7] anchors -> [..., 7] boxes.

    xy are scaled by the anchor's BEV diagonal, z by its height (centre
    form), sizes are log-ratios clamped at SIZE_DECODE_CLIP, yaw is a plain
    residual.
    """
    xa, ya, za, wa, la, ha, ra = torch.unbind(anchors, dim=-1)
    xt, yt, zt, wt, lt, ht, rt = torch.unbind(encodings, dim=-1)
    za = za + ha * 0.5
    diagonal = torch.sqrt(la * la + wa * wa)
    xg = xt * diagonal + xa
    yg = yt * diagonal + ya
    zg = zt * ha + za
    wg = torch.exp(torch.clamp(wt, max=SIZE_DECODE_CLIP)) * wa
    lg = torch.exp(torch.clamp(lt, max=SIZE_DECODE_CLIP)) * la
    hg = torch.exp(torch.clamp(ht, max=SIZE_DECODE_CLIP)) * ha
    rg = rt + ra
    zg = zg - hg * 0.5
    return torch.stack([xg, yg, zg, wg, lg, hg, rg], dim=-1)


def second_box_encode(boxes: torch.Tensor,
                      anchors: torch.Tensor) -> torch.Tensor:
    """Inverse of second_box_decode (without its clamp): [..., 7] target
    boxes against [..., 7] anchors -> [..., 7] residuals."""
    xa, ya, za, wa, la, ha, ra = torch.unbind(anchors, dim=-1)
    xg, yg, zg, wg, lg, hg, rg = torch.unbind(boxes, dim=-1)
    zg = zg + hg * 0.5
    za = za + ha * 0.5
    diagonal = torch.sqrt(la * la + wa * wa)
    return torch.stack([(xg - xa) / diagonal, (yg - ya) / diagonal,
                        (zg - za) / ha, torch.log(wg / wa),
                        torch.log(lg / la), torch.log(hg / ha), rg - ra],
                       dim=-1)


def limit_period(val: torch.Tensor, offset: float = 0.5,
                 period: float = math.pi) -> torch.Tensor:
    """Wrap into [-offset*period, (1-offset)*period)."""
    return val - torch.floor(val / period + offset) * period


def boxes3d_to_near_bev(boxes3d: torch.Tensor) -> torch.Tensor:
    """[..., 7] rotated boxes -> [..., 4] (xmin, ymin, xmax, ymax) of the
    nearest axis-aligned BEV box: extents swapped when the yaw (mod pi) is
    closer to +-pi/2."""
    x, y = boxes3d[..., 0], boxes3d[..., 1]
    w, l = boxes3d[..., 3], boxes3d[..., 4]
    rots = torch.abs(limit_period(boxes3d[..., 6], 0.5, math.pi))
    cond = rots > (math.pi / 4)
    dx = torch.where(cond, l, w)
    dy = torch.where(cond, w, l)
    return torch.stack([x - dx * 0.5, y - dy * 0.5, x + dx * 0.5,
                        y + dy * 0.5], dim=-1)


def iou_aligned(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise axis-aligned IoU of [N, 4] and [M, 4] -> [N, M]."""
    lt = torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    overlap = wh[..., 0] * wh[..., 1]
    area1 = (boxes1[:, 2] - boxes1[:, 0]) * (boxes1[:, 3] - boxes1[:, 1])
    area2 = (boxes2[:, 2] - boxes2[:, 0]) * (boxes2[:, 3] - boxes2[:, 1])
    union = area1[:, None] + area2[None, :] - overlap
    return overlap / torch.where(union > 0, union, 1.0)


def nearest_iou_similarity(boxes1: torch.Tensor,
                           boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of nearest axis-aligned BEV boxes ([N,7],[M,7] ->
    [N,M]): NearestIouSimilarity."""
    return iou_aligned(boxes3d_to_near_bev(boxes1),
                       boxes3d_to_near_bev(boxes2))


def points_in_boxes3d(points: torch.Tensor, boxes3d: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Point-in-rotated-box flags and centre offsets.

    points [..., N, 3], boxes3d [..., M, 7] -> (flags [..., N, M] bool,
    label [..., N] bool, offsets [..., N, 3]): the first box that holds a
    point wins, and its offset is point - (x, y, z + h/2).
    """
    d = points[..., :, None, :2] - boxes3d[..., None, :, :2]
    r = boxes3d[..., 6]
    c = torch.cos(r)[..., None, :]
    s = torch.sin(r)[..., None, :]
    lx = d[..., 0] * c - d[..., 1] * s
    ly = d[..., 0] * s + d[..., 1] * c
    h = boxes3d[..., None, :, 5]
    cz = boxes3d[..., None, :, 2] + h * 0.5
    in_z = torch.abs(points[..., :, None, 2] - cz) <= h * 0.5
    flags = ((torch.abs(lx) <= boxes3d[..., None, :, 3] * 0.5)
             & (torch.abs(ly) <= boxes3d[..., None, :, 4] * 0.5) & in_z)
    label, offsets = _first_box_offsets(points, boxes3d, flags)
    return flags, label, offsets


def _first_box_offsets(points, boxes3d, flags):
    label = torch.any(flags, dim=-1)
    first = torch.argmax(flags.to(torch.uint8), dim=-1)         # first True
    centers = torch.cat([boxes3d[..., :2],
                         boxes3d[..., 2:3] + boxes3d[..., 5:6] * 0.5], -1)
    picked = torch.gather(centers, -2, first[..., None].expand(
        *first.shape, 3))
    return label, torch.where(label[..., None], points - picked, 0.0)


def aux_targets_plain(points: torch.Tensor, points_valid: torch.Tensor,
                      gt_boxes: torch.Tensor, gt_valid: torch.Tensor):
    """Plain PyTorch version of K12 (see aux_targets)."""
    flags, _, _ = points_in_boxes3d(points, gt_boxes)
    flags = flags & gt_valid[:, None, :] & points_valid[:, :, None]
    return _first_box_offsets(points, gt_boxes, flags)


def aux_targets(points: torch.Tensor, points_valid: torch.Tensor,
                gt_boxes: torch.Tensor, gt_valid: torch.Tensor):
    """The aux branch's point targets (K12 on the card).

    points [B, N, 3] (voxel centroids), points_valid [B, N] bool, gt_boxes
    [B, G, 7], gt_valid [B, G] bool -> (label [B, N] bool: a valid point in
    a valid GT box; offsets [B, N, 3]: point - centre of the first such box,
    0 elsewhere).
    """
    if points.device.type == "cpu":
        return aux_targets_plain(points, points_valid, gt_boxes, gt_valid)
    points = points.contiguous()
    cuda.check_cuda("points", points, torch.float32, 3)
    cuda.check_cuda("points_valid", points_valid, torch.bool, 2)
    cuda.check_cuda("gt_boxes", gt_boxes, torch.float32, 3)
    cuda.check_cuda("gt_valid", gt_valid, torch.bool, 2)
    b, n, _ = points.shape
    g = gt_boxes.shape[1]
    if (points.shape[2] != 3 or points_valid.shape != (b, n)
            or gt_boxes.shape != (b, g, 7) or gt_valid.shape != (b, g)):
        raise ValueError(f"points {tuple(points.shape)}, gt_boxes "
                         f"{tuple(gt_boxes.shape)} do not fit")
    with torch.cuda.device(points.device):
        label = torch.empty((b, n), dtype=torch.bool, device=points.device)
        offsets = torch.empty((b, n, 3), dtype=torch.float32,
                              device=points.device)
        _K12.launch(points.data_ptr(), points_valid.data_ptr(),
                    gt_boxes.data_ptr(), gt_valid.data_ptr(), b, n, g,
                    label.data_ptr(), offsets.data_ptr())
    return label, offsets
