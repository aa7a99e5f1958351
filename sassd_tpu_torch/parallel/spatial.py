"""Spatial BEV sharding (the JAX package's ``parallel/spatial.py``): the
dense BEV trunk split along the canvas's H (y) axis over the spatial ranks
of a data row.

In the JAX package the canvas is annotated H-sharded over the mesh's
'spatial' axis and XLA inserts the halo exchanges BEVNet's 3x3 convs need.
The port makes them explicit. Rank s of a data row of S ranks holds canvas
rows [s * H / S, (s + 1) * H / S):

- :func:`canvas_slice` cuts them from a whole canvas (``strategy=
  "spatial"``: VxNet ran whole on every rank of the row); the banded
  strategy across ranks builds the slice directly from its band's owned
  rows (``Detector._banded_spine``);
- :func:`split_bev` runs BEVNet on the slice, exchanging one halo row with
  each neighbour before every 3x3 conv (zeros past the canvas's top and
  bottom edges, SAME padding of the whole), with BatchNorm over the rows
  of every rank; then all-gathers ``bev_map`` and ``conv6`` over the row
  for the heads, which run whole on every rank of it.

Gradients: the gather's backward sums the maps' gradients over the row
and keeps this rank's slice, so BEVNet (and what feeds the slice) gets
its slice's part; the terms computed whole on every rank of a row are
scaled by 1 / S in ``Detector.forward_train``, so the step's SUM over all
ranks counts each once.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import dist
from .mesh import Layout


def canvas_slice(x: torch.Tensor, lay: Layout) -> torch.Tensor:
    """This rank's rows of a [B, H, W, C] canvas: [B, H / S, W, C]."""
    h = x.shape[1] // lay.spatial
    return x.narrow(1, lay.spatial_index * h, h)


def split_bev(bevnet, bev_in: torch.Tensor, lay: Layout
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """BEVNet on this rank's canvas slice [B, H / S, W, Cin], then both
    maps gathered over the data row: (bev_map, conv6), each [B, H, W, F]
    (NHWC views of one NCHW tensor)."""
    group = lay.spatial_group
    bev_map, conv6 = bevnet(bev_in,
                            lambda t: dist.halo_exchange(t, 2, group))
    f = bev_map.shape[-1]
    both = torch.cat([bev_map.permute(0, 3, 1, 2),
                      conv6.permute(0, 3, 1, 2)], 1)        # [B, 2F, h, W]
    full = dist.gather_rows(both, 2, group)                 # [B, 2F, H, W]
    return (full[:, :f].permute(0, 2, 3, 1),
            full[:, f:].permute(0, 2, 3, 1))
