"""PSWarp sampling: rotated per-box lattices + per-part bilinear sampling.

Each box gets a window_size[0] x window_size[1] lattice in its rotated
frame, mapped to BEV pixel coordinates; part k of the part-sensitive map is
sampled bilinearly at lattice point k (zero padding outside the map,
align_corners semantics: pixel coordinates are used directly).

``pswarp_score`` (kernel K3, ``csrc/pswarp_score.cu``) fuses the lattice,
the sampling and the mean over parts; :func:`pswarp_score_plain` is its
plain PyTorch version. Its gradient reaches both the part map and the
boxes (x, y, w, l, yaw): K3b on the card, autograd of the plain version on
the CPU. When no input needs a gradient (serving, under inference_mode),
K3 launches without an autograd Function.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import cuda

_K3 = cuda.Kernel("sassd_pswarp_score",
                  [cuda.P, cuda.L, cuda.L, cuda.L, cuda.L, cuda.I, cuda.I,
                   cuda.I, cuda.P, cuda.P, cuda.I, cuda.I, cuda.I, cuda.I,
                   cuda.F, cuda.F, cuda.F, cuda.P])
_K3B = cuda.Kernel("sassd_pswarp_score_bwd",
                   [cuda.P, cuda.L, cuda.L, cuda.L, cuda.L, cuda.I, cuda.I,
                    cuda.I, cuda.P, cuda.P, cuda.P, cuda.I, cuda.I, cuda.I,
                    cuda.I, cuda.F, cuda.F, cuda.F, cuda.I, cuda.I, cuda.P,
                    cuda.P, cuda.P])
KERNEL_SYMBOLS = {"K3": ("sassd_pswarp_score",),
                  "K3b": ("sassd_pswarp_score_bwd",)}
# K3b's pass B: the tile of d_map a block writes, rows by columns (fewer
# rows where the tile would pass K3B_TILE floats of shared memory)
K3B_TILE_ROWS = 25
K3B_TILE_COLS = 96          # at most 128
K3B_TILE = 5120


def gen_sample_grid(boxes: torch.Tensor,
                    window_size: Tuple[int, int] = (4, 7),
                    grid_offsets: Tuple[float, float] = (0.0, 40.0),
                    spatial_scale: float = 2.5):
    """Per-box rotated sampling lattices.

    Args:
      boxes: [N, 5] (x, y, w, l, yaw) BEV boxes in metric lidar coords.
    Returns:
      (xs, ys): each [K, N] pixel coordinates, K = prod(window_size),
      ordered local-x-major then local-y.
    """
    n = boxes.shape[0]
    wx, wy = window_size
    x, y, w, l, r = (boxes[:, i] for i in range(5))
    lin = dict(dtype=boxes.dtype, device=boxes.device)
    xx = torch.linspace(-0.5, 0.5, wx, **lin)[None, :, None] * w[:, None, None]
    yy = torch.linspace(-0.5, 0.5, wy, **lin)[None, None, :] * l[:, None, None]
    c = torch.cos(r)[:, None, None]
    s = torch.sin(r)[:, None, None]
    gx = xx * c + yy * s + x[:, None, None]
    gy = yy * c - xx * s + y[:, None, None]
    gx = (gx + grid_offsets[0]) * spatial_scale
    gy = (gy + grid_offsets[1]) * spatial_scale
    return gx.reshape(n, wx * wy).T, gy.reshape(n, wx * wy).T


def bilinear_sample_per_part(image: torch.Tensor, xs: torch.Tensor,
                             ys: torch.Tensor) -> torch.Tensor:
    """Sample part k of `image` [H, W, K] at (xs[k], ys[k]) bilinearly.

    xs, ys: [K, N] pixel coordinates (x indexes W, y indexes H).
    Returns [K, N]; taps outside the map contribute zero.
    """
    h, w, k = image.shape
    part = torch.arange(k, device=image.device)[:, None]
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    tx = xs - x0
    ty = ys - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def tap(yi, xi, wgt):
        ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        v = image[yi.clamp(0, h - 1), xi.clamp(0, w - 1), part]
        return torch.where(ok, v, 0.0) * wgt

    return (tap(y0i, x0i, (1 - tx) * (1 - ty))
            + tap(y0i, x0i + 1, tx * (1 - ty))
            + tap(y0i + 1, x0i, (1 - tx) * ty)
            + tap(y0i + 1, x0i + 1, tx * ty))


def pswarp_score_plain(part_map: torch.Tensor, boxes: torch.Tensor,
                       valid: torch.Tensor, window_size: Tuple[int, int],
                       grid_offsets: Tuple[float, float],
                       spatial_scale: float) -> torch.Tensor:
    """Plain PyTorch version of K3.

    part_map: [B, K, H, W] (any strides); boxes [B, N, 7]; valid [B, N].
    Returns [B, N] mean part samples, 0 where not valid.
    """
    scores = []
    for b in range(boxes.shape[0]):
        xs, ys = gen_sample_grid(boxes[b][:, [0, 1, 3, 4, 6]], window_size,
                                 grid_offsets, spatial_scale)
        samples = bilinear_sample_per_part(part_map[b].permute(1, 2, 0),
                                           xs, ys)
        scores.append(torch.mean(samples, dim=0))
    return torch.where(valid, torch.stack(scores), 0.0)


def _check(part_map, boxes, valid):
    """Raise unless K3 takes these CUDA tensors (K3b too, with its
    d_score checked apart)."""
    b, k, h, w = part_map.shape
    cuda.check_cuda("part_map", part_map, torch.float32, 4, contiguous=False)
    cuda.check_cuda("boxes", boxes, torch.float32, 3)
    cuda.check_cuda("valid", valid, torch.bool, 2)
    n = boxes.shape[1]
    if boxes.shape != (b, n, 7) or valid.shape != (b, n):
        raise ValueError(f"boxes {tuple(boxes.shape)} / valid "
                         f"{tuple(valid.shape)} do not match batch {b}")
    if boxes.device != part_map.device or valid.device != part_map.device:
        raise ValueError("part_map, boxes and valid must be on one card")
    if k > 32:
        raise ValueError(f"at most 32 parts (one warp lane each), got {k}")


def _k3(part_map, boxes, valid, window_size, grid_offsets, spatial_scale):
    """K3 launch on inputs _check passed."""
    b, k, h, w = part_map.shape
    n = boxes.shape[1]
    out = torch.empty((b, n), dtype=torch.float32, device=part_map.device)
    sb, sk, sh, sw = part_map.stride()
    _K3.launch_on(part_map, part_map.data_ptr(), sb, sk, sh, sw, h, w, k,
                  boxes.data_ptr(), valid.data_ptr(), b, n, window_size[0],
                  window_size[1], float(grid_offsets[0]),
                  float(grid_offsets[1]), float(spatial_scale),
                  out.data_ptr())
    return out


def pswarp_score_grad(part_map, boxes, valid, d_score, window_size,
                      grid_offsets, spatial_scale):
    """K3b: the gradients of pswarp_score's [B, N] scores with respect to
    the part map ([B, K, H, W], contiguous) and the boxes ([B, N, 7], 0 in
    z and h), given d_score [B, N]. Two calls on the same inputs give the
    same bits."""
    _check(part_map, boxes, valid)
    return _k3b(part_map, boxes, valid, d_score, window_size, grid_offsets,
                spatial_scale)


def _k3b(part_map, boxes, valid, d_score, window_size, grid_offsets,
         spatial_scale):
    """K3b launch; part_map, boxes and valid passed _check (in the forward,
    when autograd calls it), d_score is checked here."""
    cuda.check_cuda("d_score", d_score, torch.float32, 2)
    b, k, h, w = part_map.shape
    n = boxes.shape[1]
    if d_score.shape != (b, n) or d_score.device != part_map.device:
        raise ValueError(f"d_score {tuple(d_score.shape)} on "
                         f"{d_score.device} does not match the {b} x {n} "
                         f"boxes on {part_map.device}")
    cols = max(1, min(w, K3B_TILE_COLS))
    rows = max(1, min(K3B_TILE_ROWS, K3B_TILE // cols))
    # one allocation: pass A's tap records ([B, K, N] x 4 taps, then x0 and
    # y0 as int32), d_map and d_boxes, each at a multiple of 64 floats
    n_rec = -(-b * k * n * 6 // 64) * 64
    n_map = -(-b * k * h * w // 64) * 64
    buf = torch.empty((n_rec + n_map + b * n * 7,), dtype=torch.float32,
                      device=part_map.device)
    d_map = buf[n_rec:n_rec + b * k * h * w].view(b, k, h, w)
    d_boxes = buf[n_rec + n_map:].view(b, n, 7)
    sb, sk, sh, sw = part_map.stride()
    _K3B.launch_on(part_map, part_map.data_ptr(), sb, sk, sh, sw, h, w, k,
                   boxes.data_ptr(), valid.data_ptr(), d_score.data_ptr(), b,
                   n, window_size[0], window_size[1], float(grid_offsets[0]),
                   float(grid_offsets[1]), float(spatial_scale), rows, cols,
                   buf.data_ptr(), d_map.data_ptr(), d_boxes.data_ptr())
    return d_map, d_boxes


class _PSWarpScoreFn(torch.autograd.Function):
    """pswarp_score under autograd on the card: forward K3, backward K3b.
    pswarp_score checks the inputs before apply."""

    @staticmethod
    def forward(ctx, part_map, boxes, valid, window_size, grid_offsets,
                spatial_scale):
        ctx.save_for_backward(part_map, boxes, valid)
        ctx.args = (window_size, grid_offsets, spatial_scale)
        return _k3(part_map, boxes, valid, *ctx.args)

    @staticmethod
    def backward(ctx, d_score):
        part_map, boxes, valid = ctx.saved_tensors
        d_map, d_boxes = _k3b(part_map, boxes, valid, d_score.contiguous(),
                              *ctx.args)
        return d_map, d_boxes, None, None, None, None


def pswarp_score(part_map: torch.Tensor, boxes: torch.Tensor,
                 valid: torch.Tensor, window_size: Tuple[int, int] = (4, 7),
                 grid_offsets: Tuple[float, float] = (0.0, 40.0),
                 spatial_scale: float = 2.5) -> torch.Tensor:
    """PSWarp box scores: [B,K,H,W] map, [B,N,7] boxes, [B,N] valid -> [B,N].

    The map is read through its strides (the NCHW conv output, or an NHWC
    view of it, needs no copy). Part k is sampled at lattice point k.
    Differentiable in the map and the boxes.
    """
    b, k, h, w = part_map.shape
    if k != window_size[0] * window_size[1]:
        raise ValueError(f"{k} parts for a {window_size} window")
    if part_map.device.type == "cpu":
        return pswarp_score_plain(part_map, boxes, valid, window_size,
                                  grid_offsets, spatial_scale)
    _check(part_map, boxes, valid)
    if torch.is_grad_enabled() and (part_map.requires_grad
                                    or boxes.requires_grad):
        return _PSWarpScoreFn.apply(part_map, boxes, valid,
                                    tuple(window_size), tuple(grid_offsets),
                                    float(spatial_scale))
    return _k3(part_map, boxes, valid, window_size, grid_offsets,
               spatial_scale)
