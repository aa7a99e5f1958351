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

VxNet runs at the grid it was built for or at any other of the same
depth (its weights do not depend on H or W): the banded sparse stage runs
it on band grids, with ``owned_y`` restricting the BatchNorm statistics
to the band-owned rows.

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
    """[Cin, Cout] weight (the 1x1x1 sparse conv), bias-free unless
    `bias`; both drawn U(+-1/sqrt(Cin))."""

    def __init__(self, gen: torch.Generator, cin: int, cout: int,
                 bias: bool = False):
        super().__init__()
        self.w = nn.Parameter(L.uniform_fan_in(gen, (cin, cout), cin))
        self.b = (nn.Parameter(L.uniform_fan_in(gen, (cout,), cin))
                  if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.w
        return y if self.b is None else y + self.b


class PointNetVFE(nn.Module):
    """PointNet voxel feature encoder (the reference's VFELayer stack,
    opt-in with model.vfe_type="pointnet"): each voxel's point slots get
    their offsets from the voxel's point mean appended; then per layer
    linear -> BatchNorm over the valid slots -> ReLU, and each slot's
    features are concatenated with their masked max over the voxel's
    valid slots (0 for a voxel with none). A final linear maps the last
    layer's pooled features to `out_features`, so the sparse ladder sees
    the width it expects. Children fc{i}, bn{i}, out as in the JAX
    package's params, so weights convert by name. Stock ops only."""

    def __init__(self, gen: torch.Generator, num_input_features: int,
                 units: Tuple[int, ...] = (32, 64), out_features: int = 4):
        super().__init__()
        self.n = len(units)
        cin = num_input_features + 3
        for i, u in enumerate(units):
            setattr(self, f"fc{i}", Linear(gen, cin, u, bias=True))
            setattr(self, f"bn{i}", L.BatchNorm(u))
            cin = 2 * u
        self.out = Linear(gen, cin, out_features, bias=True)

    def forward(self, voxels: torch.Tensor,
                num_points: torch.Tensor) -> torch.Tensor:
        """[B, V, T, F], [B, V] -> [B, V, out_features]. BatchNorm (train
        mode) takes its statistics over the valid slots only, through
        layers.masked_moments, so SyncBN holds under a process group."""
        t = voxels.shape[-2]
        denom = torch.clamp(num_points, min=1).to(voxels.dtype)[..., None]
        mean_xyz = torch.sum(voxels[..., :3], dim=-2) / denom
        x = torch.cat([voxels, voxels[..., :3] - mean_xyz[..., None, :]],
                      dim=-1)
        valid = (torch.arange(t, device=voxels.device)
                 < num_points[..., None])[..., None]      # [B, V, T, 1]

        def masked_max(y):
            m = torch.amax(torch.where(valid, y, -torch.inf), dim=-2)
            return torch.where(torch.isfinite(m), m, torch.zeros_like(m))

        for i in range(self.n):
            x = getattr(self, f"bn{i}")(getattr(self, f"fc{i}")(x),
                                        mask=valid)
            x = L.relu(x)
            pooled = masked_max(x)
            x = torch.cat([x, pooled[..., None, :].expand_as(x)], dim=-1)
        return self.out(masked_max(x))


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


def level_shapes(sparse_shape: Tuple[int, int, int]
                 ) -> List[Tuple[int, int, int]]:
    """The grids (zyx) of levels 0-3 of the ladder on `sparse_shape`."""
    shapes = [tuple(sparse_shape)]
    for _ in range(3):
        shapes.append(sp.out_shape_stride2(shapes[-1]))
    return shapes


def _owned_rows(keys: torch.Tensor, shape: Tuple[int, int, int],
                level: int, owned_y: Optional[Tuple[int, int]]
                ) -> torch.Tensor:
    """[B, M] valid rows of a level, restricted to y in [lo >> level,
    hi >> level) when the level-0 range owned_y = (lo, hi) is given."""
    ok = keys != sp.INVALID_KEY
    if owned_y is None:
        return ok
    y = (keys // shape[2]) % shape[1]
    return ok & (y >= owned_y[0] >> level) & (y < owned_y[1] >> level)


class Middle(NamedTuple):
    """Rows of one backbone level for the aux branch."""
    keys: torch.Tensor      # [B, M] int32 keys (INVALID_KEY padded)
    feats: torch.Tensor     # [B, M, C]


class VxNet(nn.Module):

    def __init__(self, gen: torch.Generator, num_input_features: int,
                 sparse_shape: Tuple[int, int, int]):
        super().__init__()
        self.level_shapes = level_shapes(sparse_shape)        # L0..L3 (zyx)
        self.shape3 = self.level_shapes[3]
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
              plans: Dict[str, torch.Tensor], level: int, shapes, owned_y):
        """Stride-2 conv into level `level`: the rulebook's coords give
        the output active set, the stride plan indexes the previous level's
        rows (and the transpose plan, where the rulebook has it, serves the
        backward)."""
        out_keys = sp.coords_to_keys(plans[f"coords{level}"], shapes[level])
        if f"strideT{level}" in plans:
            y = sp.stride_conv_hostT(x, block.conv0.w, plans[f"stride{level}"],
                                     plans[f"strideT{level}"])
        else:
            y = sp.subm_conv_batched(x, block.conv0.w,
                                     plans[f"stride{level}"])
        omask = (out_keys != sp.INVALID_KEY)[..., None]
        bn_mask = _owned_rows(out_keys, shapes[level], level, owned_y)
        y = block.bn0(y, mask=bn_mask[..., None])
        return out_keys, L.relu(y) * omask

    def forward(self, feats0: torch.Tensor, plans: Dict[str, torch.Tensor],
                shapes=None, owned_y=None) -> torch.Tensor:
        """[B, cap0, F] voxel features + rulebook -> [B, D, H, W, 64].

        plans: subm0..2 [B,27,capL], stride1..3 [B,27,capL] and coords1..3
        [B,capL,3] (int16 or int32, -1 = missing/padding), from the host
        (data.kitti.build_host_plans) or the device (sp.device_rulebook).
        shapes: the four level grids the plans are on (default: the grid
        the net was built for). owned_y: optional level-0 y range (lo, hi)
        of the rows BatchNorm statistics count (train mode).
        """
        return self._run(feats0, plans, None, shapes, owned_y)[0]

    def forward_train(self, feats0: torch.Tensor, keys0: torch.Tensor,
                      plans: Dict[str, torch.Tensor], shapes=None,
                      owned_y=None) -> Tuple[torch.Tensor, List[Middle]]:
        """forward, plus the aux branch's middles: the rows of levels 1
        and 2 after their subm blocks, and level 3's rows of the conv3
        block's output (before the 1x1x1 conv)."""
        return self._run(feats0, plans, keys0, shapes, owned_y)

    def _run(self, feats0, plans, keys0, shapes, owned_y):
        """keys0 (the level-0 keys) gives level 0's BatchNorm mask; train
        mode needs it, eval mode reads no mask."""
        shapes = shapes or self.level_shapes
        mask0 = (None if keys0 is None
                 else _owned_rows(keys0, shapes[0], 0, owned_y))
        x = self.conv0(feats0, plans["subm0"], mask0)
        keys1, x = self._down(self.down0, x, plans, 1, shapes, owned_y)
        x = self.conv1(x, plans["subm1"],
                       _owned_rows(keys1, shapes[1], 1, owned_y))
        mid0 = Middle(keys1, x)
        keys2, x = self._down(self.down1, x, plans, 2, shapes, owned_y)
        x = self.conv2(x, plans["subm2"],
                       _owned_rows(keys2, shapes[2], 2, owned_y))
        mid1 = Middle(keys2, x)
        keys3, x = self._down(self.down2, x, plans, 3, shapes, owned_y)
        out, conv3 = self._dense_tail(keys3, x, shapes[3], owned_y)
        if keys0 is None:
            return out, None
        return out, [mid0, mid1, Middle(keys3, sp.gather_rows(keys3, conv3))]

    def _dense_tail(self, keys3: torch.Tensor, x: torch.Tensor, shape3,
                    owned_y):
        """-> ([B, D, H, W, C] output, [B, D, C, H, W] conv3-block output)."""
        d, h, w = shape3
        b, _, c = x.shape
        xf, occ = sp.densify_nchw(keys3, x, shape3)       # ch = z*C + c
        bn_mask = occ > 0                                  # [B, D, 1, H, W]
        if owned_y is not None:
            yr = torch.arange(h, device=occ.device)
            bn_mask = bn_mask & ((yr >= owned_y[0] >> 3)
                                 & (yr < owned_y[1] >> 3))[:, None]
        for i in range(self.conv3.n):
            wt = (zbanded_oihw(getattr(self.conv3, f"conv{i}").w, d)
                  if self.training else getattr(self, f"tail_w{i}"))
            xf = F.conv2d(xf, wt, padding=1)
            x5 = xf.reshape(b, d, c, h, w) * occ
            x5 = L.relu(getattr(self.conv3, f"bn{i}")(
                x5, dim=2, mask=bn_mask)) * occ
            xf = x5.reshape(b, d * c, h, w)
        conv3 = x5
        # 1x1x1 conv: one [C, C] matmul per z slice, as a 1x1 conv
        x5 = L.conv2d_nchw(xf.reshape(b * d, c, h, w),
                           self.extra.conv0.w[None, None])
        x5 = x5.reshape(b, d, c, h, w) * occ
        x5 = L.relu(self.extra.bn0(x5, dim=2, mask=bn_mask)) * occ
        return x5.permute(0, 1, 3, 4, 2), conv3                 # [B,D,H,W,C]
