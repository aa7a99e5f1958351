"""Dense BEV trunk: 7 x [3x3 conv + BN + ReLU], then 1x1 conv + BN + ReLU.

Returns the final map (SSD head input) and the pre-1x1 ``conv6`` map
(PSWarp input). Public layout NHWC; the convs run NCHW on cuDNN, in
float32 or, with model.compute_dtype="bfloat16", in bfloat16 with their
outputs taken back to float32 (layers.conv2d_oihw); BatchNorm in float32.

Split over the spatial ranks of a data row (parallel/spatial.py), each
rank runs its own rows of the canvas: a `halo` hook pads every 3x3 conv's
input with one row from each neighbour (parallel/dist.halo_exchange), the
conv then pads only W, and BatchNorm takes the rank's own rows (reduced
over the group of layers.stats_group).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from . import layers as L

N_CONV = 7


class BEVNet(nn.Module):

    def __init__(self, gen: torch.Generator, in_features: int,
                 num_filters: int = 256, compute_dtype=torch.float32):
        super().__init__()
        cin = in_features
        for i in range(N_CONV):
            setattr(self, f"conv{i}", L.Conv2d(gen, 3, cin, num_filters,
                                               compute_dtype=compute_dtype))
            setattr(self, f"bn{i}", L.BatchNorm(num_filters))
            cin = num_filters
        self.conv7 = L.Conv2d(gen, 1, cin, num_filters,
                              compute_dtype=compute_dtype)
        self.bn7 = L.BatchNorm(num_filters)

    def forward(self, x: torch.Tensor,
                halo: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, H, W, Cin] -> (final [B,H,W,F], conv6 [B,H,W,F]).

        halo: NCHW [B, C, h, W] -> [B, C, h + 2, W], the rows above and
        below this rank's slice (None: x is the whole canvas). The outputs
        are NHWC views of NCHW tensors."""
        x = x.permute(0, 3, 1, 2)
        for i in range(N_CONV):
            conv = getattr(self, f"conv{i}")
            x = conv(x) if halo is None else conv(halo(x), padding=(0, 1))
            x = L.relu(getattr(self, f"bn{i}")(x, dim=1))
        conv6 = x
        x = L.relu(self.bn7(self.conv7(x), dim=1))
        return x.permute(0, 2, 3, 1), conv6.permute(0, 2, 3, 1)
