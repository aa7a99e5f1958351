"""Layer helpers: initialisers, conv and BatchNorm modules and ops.

Parameters keep the JAX package's layouts (conv HWIO, sparse conv
[27, Cin, Cout], 1x1x1 conv [Cin, Cout]) so weights convert one to one;
the modules permute to PyTorch's layouts where they call a PyTorch op.
Every BatchNorm of the model uses eps 1e-3 and momentum 0.01.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
BN_MOMENTUM = 0.01


def uniform_fan_in(gen: torch.Generator, shape: Tuple[int, ...],
                   fan_in: int) -> torch.Tensor:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) drawn on the CPU from `gen`."""
    bound = 1.0 / math.sqrt(fan_in)
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


class Conv2d(nn.Module):
    """SAME-padded, stride-1 conv with an HWIO weight (and optional bias)."""

    def __init__(self, gen: torch.Generator, ksize: int, cin: int, cout: int,
                 bias: bool = False):
        super().__init__()
        fan_in = cin * ksize * ksize
        self.w = nn.Parameter(uniform_fan_in(gen, (ksize, ksize, cin, cout),
                                             fan_in))
        self.b = (nn.Parameter(uniform_fan_in(gen, (cout,), fan_in))
                  if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW in, NCHW out."""
        return conv2d_nchw(x, self.w, self.b)


class SparseConv3(nn.Module):
    """Weight [27, Cin, Cout] of a 3x3x3 gather-GEMM sparse conv."""

    def __init__(self, gen: torch.Generator, cin: int, cout: int):
        super().__init__()
        self.w = nn.Parameter(uniform_fan_in(gen, (27, cin, cout), cin * 27))


class BatchNorm(nn.Module):
    """BatchNorm over the channel axis `dim`, with an optional row mask.

    In eval mode it normalises with the running statistics. In train mode
    it normalises with the batch statistics over the rows where `mask` is
    set (padded sparse rows and empty dense cells are invisible) and
    updates the running buffers: (1-m)·running + m·batch, with the
    unbiased variance. torch's nn.BatchNorm has no mask, so it is not used.
    A new BatchNorm is in eval mode (the modules serve unless trained).
    """

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))
        self.train(False)

    def forward(self, x: torch.Tensor, dim: int = -1,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mask: bool, x's shape with size 1 at `dim` (or broadcastable to
        it), set on the rows that count; train mode only."""
        if not self.training:
            return batch_norm(x, self.scale, self.bias, self.mean, self.var,
                              dim)
        mean, var, n = masked_moments(x, dim, mask)
        with torch.no_grad():
            unbiased = var * (n / torch.clamp(n - 1.0, min=1.0))
            self.mean.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
            self.var.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * unbiased)
        return batch_norm(x, self.scale, self.bias, mean, var, dim)


def masked_moments(x: torch.Tensor, dim: int,
                   mask: Optional[torch.Tensor]):
    """Per-channel mean and biased variance of x over all axes but `dim`,
    over the rows where `mask` is set; and the row count (>= 1)."""
    dim = dim % x.dim()
    red = [i for i in range(x.dim()) if i != dim]
    shape = [1] * x.dim()
    shape[dim] = -1
    if mask is None:
        n = torch.tensor(float(x.numel() // x.shape[dim]), device=x.device)
        mean = torch.mean(x, dim=red)
        diff = x - mean.reshape(shape)
        return mean, torch.mean(diff * diff, dim=red), n
    m = mask.to(x.dtype)
    n = torch.clamp(torch.sum(m), min=1.0)
    mean = torch.sum(x * m, dim=red) / n
    diff = (x - mean.reshape(shape)) * m
    return mean, torch.sum(diff * diff, dim=red) / n, n


def conv2d_nchw(x: torch.Tensor, w_hwio: torch.Tensor, b=None) -> torch.Tensor:
    """NCHW conv with an HWIO weight, SAME padding for odd kernels."""
    k = w_hwio.shape[0]
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1), b, padding=k // 2)


def conv2d(x: torch.Tensor, w_hwio: torch.Tensor, b=None) -> torch.Tensor:
    """NHWC conv with an HWIO weight, SAME padding, stride 1."""
    return conv2d_nchw(x.permute(0, 3, 1, 2), w_hwio, b).permute(0, 2, 3, 1)


def batch_norm(x: torch.Tensor, scale, bias, mean, var,
               dim: int = -1) -> torch.Tensor:
    """BatchNorm over channel axis `dim` with the given statistics:
    (x-mean) * rsqrt(var+eps) * scale + bias, the JAX package's order of
    operations."""
    shape = [1] * x.dim()
    shape[dim] = -1
    inv = torch.rsqrt(var + BN_EPS)
    return ((x - mean.reshape(shape)) * (inv * scale).reshape(shape)
            + bias.reshape(shape))


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0.0)
