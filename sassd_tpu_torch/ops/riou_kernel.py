"""K1: pairwise rotated-rectangle overlap (Green's theorem, slab clipping).

``rotate_overlap`` runs the CUDA kernel (``csrc/riou_overlap.cu``) on CUDA
tensors and :func:`rotate_overlap_plain` on CPU tensors. The plain version
is the same float32 sequence as the JAX package's ``rotate_overlap_green``:
for convex A and B the boundary of their intersection is (edges of A
clipped to B) + (edges of B clipped to A), so the area is half the sum of
cross(p, q) over those clipped, CCW-directed segments. Coincident
boundaries (identical or edge-touching boxes) are resolved by a
direction-aware eps tie-break; see ``_clipped_cross_sum``.

The kernel runs the full clipping only for the pairs that
:func:`near_pairs_plain` keeps: a pair whose centres lie farther apart than
the sum of the boxes' circumradii plus CULL_MARGIN cannot touch, and the
plain version gives it exactly +0.0 in every criterion, which the kernel
writes without clipping. A box with a non-finite field, or a centre or a
size beyond CULL_LIMIT, is never culled.

Non-differentiable by design: every consumer makes discrete decisions
(NMS) from the overlaps.
"""
from __future__ import annotations

import torch

from . import cuda

EPS_SHRINK = 1e-5
# the separation cull (csrc/riou_overlap.cu): a margin of 1 cm, 40 times the
# float32 spacing at 2,048 m, which bounds every coordinate that the
# clipping computes for boxes with centres and sizes within CULL_LIMIT
CULL_MARGIN = 1e-2
CULL_LIMIT = 1000.0

_K1 = cuda.Kernel("sassd_riou_overlap",
                  [cuda.P, cuda.I, cuda.P, cuda.I, cuda.I, cuda.P])


def _corners(x, y, w, l, r):
    """CCW corner list [4 of (x, y)] for center boxes with clockwise yaw."""
    c = torch.cos(r)
    s = torch.sin(r)
    out = []
    for sx, sy in ((0.5, 0.5), (-0.5, 0.5), (-0.5, -0.5), (0.5, -0.5)):
        lx = sx * w
        ly = sy * l
        out.append((lx * c + ly * s + x, -lx * s + ly * c + y))
    return out


def _safe_recip(d):
    """1/d with a sign-preserving 1e-12 floor (no NaN on parallel edges)."""
    tiny = 1e-12
    safe = torch.where(d >= 0, torch.clamp(d, min=tiny),
                       torch.clamp(d, max=-tiny))
    return 1.0 / safe


def _clipped_cross_sum(corners, cx, cy, cc, cs, hw, hl, subject: bool):
    """Sum of cross(p', q') over the 4 directed edges of `corners`, each
    clipped to the rectangle (center (cx, cy), cos/sin (cc, cs), half dims
    (hw, hl)) by a slab test in its local frame; endpoints in the global
    frame.

    subject=True: a face is widened by EPS_SHRINK where the segment runs
    along the face's CCW direction (the arc belongs to the intersection
    boundary) and narrowed otherwise (anti-parallel arcs cancel).
    subject=False: every face narrowed, so the subject pass alone counts
    coincident arcs.
    """
    eps = EPS_SHRINK
    loc = []
    for gx, gy in corners:
        dx = gx - cx
        dy = gy - cy
        loc.append((dx * cc - dy * cs, dx * cs + dy * cc))
    acc = 0.0
    for e in range(4):
        pgx, pgy = corners[e]
        qgx, qgy = corners[(e + 1) % 4]
        plx, ply = loc[e]
        qlx, qly = loc[(e + 1) % 4]
        dlx = qlx - plx
        dly = qly - ply
        if subject:
            x_hi = hw + torch.where(dly > 0, eps, -eps)
            x_lo = -hw - torch.where(dly < 0, eps, -eps)
            y_hi = hl + torch.where(dlx < 0, eps, -eps)
            y_lo = -hl - torch.where(dlx > 0, eps, -eps)
        else:
            x_hi, x_lo = hw - eps, -hw + eps
            y_hi, y_lo = hl - eps, -hl + eps
        rdx = _safe_recip(dlx)
        rdy = _safe_recip(dly)
        tx1 = (x_lo - plx) * rdx
        tx2 = (x_hi - plx) * rdx
        ty1 = (y_lo - ply) * rdy
        ty2 = (y_hi - ply) * rdy
        t0 = torch.clamp(torch.maximum(torch.minimum(tx1, tx2),
                                       torch.minimum(ty1, ty2)), min=0.0)
        t1 = torch.clamp(torch.minimum(torch.maximum(tx1, tx2),
                                       torch.maximum(ty1, ty2)), max=1.0)
        hit = t1 > t0
        egx = qgx - pgx
        egy = qgy - pgy
        x0 = pgx + t0 * egx
        y0 = pgy + t0 * egy
        x1 = pgx + t1 * egx
        y1 = pgy + t1 * egy
        acc = acc + torch.where(hit, x0 * y1 - x1 * y0, 0.0)
    return acc


def rotate_overlap_plain(boxes_a: torch.Tensor, boxes_b: torch.Tensor,
                         criterion: int = 2) -> torch.Tensor:
    """Plain PyTorch version of K1: [N,5] x [M,5] -> [N,M] float32."""
    a = boxes_a.float()
    b = boxes_b.float()
    ax, ay, aw, al, ar = (a[:, i][:, None] for i in range(5))
    bx, by, bw, bl, br = (b[:, i][None, :] for i in range(5))
    ca = _corners(ax, ay, aw, al, ar)
    cb = _corners(bx, by, bw, bl, br)
    s = _clipped_cross_sum(ca, bx, by, torch.cos(br), torch.sin(br),
                           bw * 0.5, bl * 0.5, subject=True)
    s = s + _clipped_cross_sum(cb, ax, ay, torch.cos(ar), torch.sin(ar),
                               aw * 0.5, al * 0.5, subject=False)
    inter = torch.clamp(s * 0.5, min=0.0)
    inter = torch.broadcast_to(inter, (a.shape[0], b.shape[0]))
    if criterion == 2:
        return inter
    a_area = aw * al
    b_area = bw * bl
    if criterion == -1:
        denom = a_area + b_area - inter
    elif criterion == 0:
        denom = torch.broadcast_to(a_area, inter.shape)
    else:
        denom = torch.broadcast_to(b_area, inter.shape)
    return inter / torch.clamp(denom, min=1e-7)


def _cull_radius(boxes: torch.Tensor) -> torch.Tensor:
    """[N] float32 circumradius of each box, NaN where the box is never
    culled (a non-finite field, a centre or a size beyond CULL_LIMIT)."""
    b = boxes.float()
    x, y, w, l, _ = b.unbind(1)
    ok = (torch.isfinite(b).all(1) & (x.abs() <= CULL_LIMIT)
          & (y.abs() <= CULL_LIMIT) & (w.abs() <= CULL_LIMIT)
          & (l.abs() <= CULL_LIMIT))
    return torch.where(ok, 0.5 * torch.sqrt(w * w + l * l), torch.nan)


def near_pairs_plain(boxes_a: torch.Tensor,
                     boxes_b: torch.Tensor) -> torch.Tensor:
    """[N, M] bool: the pairs that K1 clips in full, in its float32
    operations. The others have centres farther apart than r_a + r_b +
    CULL_MARGIN, and the plain version gives them exactly +0.0. A NaN
    radius makes the comparison false, so such a pair stays near."""
    a, b = boxes_a.float(), boxes_b.float()
    dx = a[:, 0][:, None] - b[:, 0][None, :]
    dy = a[:, 1][:, None] - b[:, 1][None, :]
    reach = (_cull_radius(a)[:, None] + _cull_radius(b)[None, :]
             + CULL_MARGIN)
    return ~(dx * dx + dy * dy > reach * reach)


def rotate_overlap(boxes_a: torch.Tensor, boxes_b: torch.Tensor,
                   criterion: int = 2) -> torch.Tensor:
    """Pairwise rotated overlap/IoU: [N,5] x [M,5] -> [N,M] float32.

    criterion: 2 raw intersection area, -1 IoU, 0 inter/area_a,
    1 inter/area_b. Zero boxes (padding) give zero overlap.
    """
    if criterion not in (2, -1, 0, 1):
        raise ValueError(f"criterion must be 2, -1, 0 or 1, got {criterion}")
    if boxes_a.device.type == "cpu" and boxes_b.device.type == "cpu":
        return rotate_overlap_plain(boxes_a, boxes_b, criterion)
    for name, t in (("boxes_a", boxes_a), ("boxes_b", boxes_b)):
        cuda.check_cuda(name, t, torch.float32, 2)
        if t.shape[1] != 5:
            raise ValueError(f"{name} must be [*, 5], got {tuple(t.shape)}")
    n, m = boxes_a.shape[0], boxes_b.shape[0]
    with torch.cuda.device(boxes_a.device):
        out = torch.empty((n, m), dtype=torch.float32, device=boxes_a.device)
        _K1.launch(boxes_a.data_ptr(), n, boxes_b.data_ptr(), m, criterion,
                   out.data_ptr())
    return out
