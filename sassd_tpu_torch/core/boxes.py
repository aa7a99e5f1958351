"""Residual (SECOND-style) box decoding.

Box layout: [x, y, z, w, l, h, yaw] in the lidar frame, z = bottom centre.
"""
from __future__ import annotations

import torch

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
