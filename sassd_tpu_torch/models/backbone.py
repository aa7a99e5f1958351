"""Voxel feature encoding + sparse 3D backbone (VxNet).

The ladder is

    double(Cin->16) -> /2 -> double(32) -> /2 -> triple(64) -> /2
    -> triple(64) -> 1x1x1 conv(64)

over fixed-capacity, key-sorted level arrays with the gather plans of a
rulebook: the C++ host rulebook's, or the same plans built on the device
(sparse.device_rulebook). Levels 0-2 are gather-GEMM sparse convs (K4);
level 3 (the dense tail) is scattered into a dense canvas (K5) and runs as
masked dense convs on [B, D*C, H, W] with z-banded weights: a conv
followed by multiplication with the occupancy mask is exactly the
submanifold conv, and D = 5 folds into the channels.

In train mode every BatchNorm takes masked batch statistics (the level's
valid rows, or the occupied cells of the dense tail), the convs are
differentiable (sparse.subm_conv_sym, sparse.stride_conv_hostT with the
host rulebook's transpose plans, sparse.densify_nchw), the z-banded
weights are rebuilt from conv3's weights at every step, and
:meth:`VxNet.forward_train` also returns the aux branch's middle levels.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sassd_tpu_torch.ops import sparse as sp
from . import layers as L


def vfe_mean(voxels: torch.Tensor, num_points: torch.Tensor) -> torch.Tensor:
    """Mean-of-points VFE: [B,V,T,F], [B,V] -> [B,V,F]."""
    denom = torch.clamp(num_points, min=1).to(voxels.dtype)[..., None]
    return torch.sum(voxels, dim=-2) / denom


class Linear(nn.Module):
    """Bias-free [Cin, Cout] weight (the 1x1x1 sparse conv)."""

    def __init__(self, gen: torch.Generator, cin: int, cout: int):
        super().__init__()
        self.w = nn.Parameter(L.uniform_fan_in(gen, (cin, cout), cin))


class SubmBlock(nn.Module):
    """n x (3x3x3 sparse conv + BN + ReLU); child names conv{i}, bn{i}."""

    def __init__(self, gen: torch.Generator, cins, couts):
        super().__init__()
        self.n = len(cins)
        for i, (ci, co) in enumerate(zip(cins, couts)):
            setattr(self, f"conv{i}", L.SparseConv3(gen, ci, co))
            setattr(self, f"bn{i}", L.BatchNorm(co))

    def forward(self, x: torch.Tensor, plan: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        """[B, M, Cin] rows on one level + its [B, 27, M] plan and [B, M]
        valid-row mask (BatchNorm statistics; train mode) -> [B, M, Cout]."""
        bn_mask = None if mask is None else mask[..., None]
        for i in range(self.n):
            x = sp.subm_conv_sym(x, getattr(self, f"conv{i}").w, plan)
            x = L.relu(getattr(self, f"bn{i}")(x, mask=bn_mask))
        return x


def zbanded_oihw(w27: torch.Tensor, d: int) -> torch.Tensor:
    """[27, Cin, Cout] 3x3x3 weight -> [D*Cout, D*Cin, 3, 3] 2D weight.

    Input channel zi*Cin + ci feeds output channel zo*Cout + co through tap
    dz = zi - zo, so the 2D conv over [B, D*C, H, W] is the 3D conv with
    z padding 1.
    """
    k, cin, cout = w27.shape
    w = w27.reshape(3, 3, 3, cin, cout)                        # (dz,dy,dx)
    out = w27.new_zeros((d, cout, d, cin, 3, 3))
    for zo in range(d):
        for zi in range(max(0, zo - 1), min(d, zo + 2)):
            out[zo, :, zi] = w[zi - zo + 1].permute(3, 2, 0, 1)
    return out.reshape(d * cout, d * cin, 3, 3)


class Middle(NamedTuple):
    """Rows of one backbone level for the aux branch."""
    keys: torch.Tensor      # [B, M] int32 keys (INVALID_KEY padded)
    feats: torch.Tensor     # [B, M, C]


class VxNet(nn.Module):

    def __init__(self, gen: torch.Generator, num_input_features: int,
                 sparse_shape: Tuple[int, int, int]):
        super().__init__()
        shapes = [tuple(sparse_shape)]
        for _ in range(3):
            shapes.append(sp.out_shape_stride2(shapes[-1]))
        self.level_shapes = shapes                             # L0..L3 (zyx)
        self.shape3 = shapes[3]
        self.conv0 = SubmBlock(gen, (num_input_features, 16), (16, 16))
        self.down0 = SubmBlock(gen, (16,), (32,))
        self.conv1 = SubmBlock(gen, (32, 32), (32, 32))
        self.down1 = SubmBlock(gen, (32,), (64,))
        self.conv2 = SubmBlock(gen, (64, 64, 64), (64, 64, 64))
        self.down2 = SubmBlock(gen, (64,), (64,))
        self.conv3 = SubmBlock(gen, (64, 64, 64), (64, 64, 64))
        self.extra = nn.Module()
        self.extra.conv0 = Linear(gen, 64, 64)
        self.extra.bn0 = L.BatchNorm(64)
        self.build_tail_weights()
        self.register_load_state_dict_post_hook(
            lambda module, _keys: module.build_tail_weights())

    @torch.no_grad()
    def build_tail_weights(self) -> None:
        """Derive the dense tail's z-banded weights from conv3's weights
        (the eval-mode cache; train mode rebuilds them every step)."""
        d = self.shape3[0]
        for i in range(self.conv3.n):
            w = zbanded_oihw(getattr(self.conv3, f"conv{i}").w.detach(), d)
            self.register_buffer(f"tail_w{i}", w, persistent=False)

    def train(self, mode: bool = True):
        was_training = self.training
        super().train(mode)
        if was_training and not mode:  # the weights may have been trained
            self.build_tail_weights()
        return self

    def _down(self, block: SubmBlock, x: torch.Tensor,
              plans: Dict[str, torch.Tensor], level: int):
        """Stride-2 conv into level `level`: the rulebook's coords give
        the output active set, the stride plan indexes the previous level's
        rows (and the transpose plan, where the rulebook has it, serves the
        backward)."""
        out_keys = sp.coords_to_keys(plans[f"coords{level}"],
                                     self.level_shapes[level])
        if f"strideT{level}" in plans:
            y = sp.stride_conv_hostT(x, block.conv0.w, plans[f"stride{level}"],
                                     plans[f"strideT{level}"])
        else:
            y = sp.subm_conv_batched(x, block.conv0.w,
                                     plans[f"stride{level}"])
        omask = (out_keys != sp.INVALID_KEY)[..., None]
        return out_keys, L.relu(block.bn0(y, mask=omask)) * omask

    def forward(self, feats0: torch.Tensor,
                plans: Dict[str, torch.Tensor]) -> torch.Tensor:
        """[B, cap0, F] voxel features + rulebook -> [B, D, H, W, 64].

        plans: subm0..2 [B,27,capL], stride1..3 [B,27,capL] and coords1..3
        [B,capL,3] (int16 or int32, -1 = missing/padding), from the host
        (data.kitti.build_host_plans) or the device (sp.device_rulebook).
        """
        return self._run(feats0, plans)[0]

    def forward_train(self, feats0: torch.Tensor, keys0: torch.Tensor,
                      plans: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, List[Middle]]:
        """forward, plus the aux branch's middles: the rows of levels 1
        and 2 after their subm blocks, and level 3's rows of the conv3
        block's output (before the 1x1x1 conv)."""
        return self._run(feats0, plans, keys0)

    def _run(self, feats0, plans, keys0=None):
        """keys0 (the level-0 keys) gives level 0's BatchNorm mask; train
        mode needs it, eval mode reads no mask."""
        mask0 = None if keys0 is None else keys0 != sp.INVALID_KEY
        x = self.conv0(feats0, plans["subm0"], mask0)
        keys1, x = self._down(self.down0, x, plans, 1)
        x = self.conv1(x, plans["subm1"], keys1 != sp.INVALID_KEY)
        mid0 = Middle(keys1, x)
        keys2, x = self._down(self.down1, x, plans, 2)
        x = self.conv2(x, plans["subm2"], keys2 != sp.INVALID_KEY)
        mid1 = Middle(keys2, x)
        keys3, x = self._down(self.down2, x, plans, 3)
        out, conv3 = self._dense_tail(keys3, x)
        if keys0 is None:
            return out, None
        return out, [mid0, mid1, Middle(keys3, sp.gather_rows(keys3, conv3))]

    def _dense_tail(self, keys3: torch.Tensor, x: torch.Tensor):
        """-> ([B, D, H, W, C] output, [B, D, C, H, W] conv3-block output)."""
        d, h, w = self.shape3
        b, _, c = x.shape
        xf, occ = sp.densify_nchw(keys3, x, self.shape3)  # ch = z*C + c
        for i in range(self.conv3.n):
            wt = (zbanded_oihw(getattr(self.conv3, f"conv{i}").w, d)
                  if self.training else getattr(self, f"tail_w{i}"))
            xf = F.conv2d(xf, wt, padding=1)
            x5 = xf.reshape(b, d, c, h, w) * occ
            x5 = L.relu(getattr(self.conv3, f"bn{i}")(
                x5, dim=2, mask=occ > 0)) * occ
            xf = x5.reshape(b, d * c, h, w)
        conv3 = x5
        # 1x1x1 conv: one [C, C] matmul per z slice, as a 1x1 conv
        x5 = L.conv2d_nchw(xf.reshape(b * d, c, h, w),
                           self.extra.conv0.w[None, None])
        x5 = x5.reshape(b, d, c, h, w) * occ
        x5 = L.relu(self.extra.bn0(x5, dim=2, mask=occ > 0)) * occ
        return x5.permute(0, 1, 3, 4, 2), conv3                 # [B,D,H,W,C]
