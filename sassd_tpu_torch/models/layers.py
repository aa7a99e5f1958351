"""Layer helpers: initialisers, conv and BatchNorm modules and ops.

Parameters keep the JAX package's layouts (conv HWIO, sparse conv
[27, Cin, Cout], 1x1x1 conv [Cin, Cout]) so weights convert one to one;
the modules permute to PyTorch's layouts where they call a PyTorch op.
Every BatchNorm of the model uses eps 1e-3 and momentum 0.01.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sassd_tpu_torch.parallel import dist

BN_EPS = 1e-3
BN_MOMENTUM = 0.01

# the process group BatchNorm statistics reduce over (None: every rank)
_STATS_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "sassd_bn_stats_group", default=None)


@contextlib.contextmanager
def stats_group(group):
    """Inside the block, every BatchNorm in train mode reduces its batch
    statistics over `group` (None: every rank of the process group). A
    module that runs whole on every rank of a data row reduces over the
    data axis (parallel/mesh.Layout.data_group), so each row counts once;
    a module that runs on a rank's own slice or band reduces over the
    world."""
    token = _STATS_GROUP.set(group)
    try:
        yield
    finally:
        _STATS_GROUP.reset(token)


def uniform_fan_in(gen: torch.Generator, shape: Tuple[int, ...],
                   fan_in: int) -> torch.Tensor:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) drawn on the CPU from `gen`."""
    bound = 1.0 / math.sqrt(fan_in)
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


class Conv2d(nn.Module):
    """SAME-padded, stride-1 conv with an HWIO weight (and optional bias),
    run in `compute_dtype` (see conv2d_oihw)."""

    def __init__(self, gen: torch.Generator, ksize: int, cin: int, cout: int,
                 bias: bool = False, compute_dtype=torch.float32):
        super().__init__()
        fan_in = cin * ksize * ksize
        self.w = nn.Parameter(uniform_fan_in(gen, (ksize, ksize, cin, cout),
                                             fan_in))
        self.b = (nn.Parameter(uniform_fan_in(gen, (cout,), fan_in))
                  if bias else None)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor, padding=None) -> torch.Tensor:
        """NCHW in, NCHW out; `padding` as conv2d_nchw takes it."""
        return conv2d_nchw(x, self.w, self.b, padding, self.compute_dtype)


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
    unbiased variance. Under a process group the batch is the global one
    (see masked_moments, over the group of :func:`stats_group`), so the
    buffers stay equal on every rank.
    torch's nn.BatchNorm has no mask, so it is not used.
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
        mean, var, n = masked_moments(x, dim, mask, _STATS_GROUP.get())
        with torch.no_grad():
            unbiased = var * (n / torch.clamp(n - 1.0, min=1.0))
            self.mean.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
            self.var.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * unbiased)
        return batch_norm(x, self.scale, self.bias, mean, var, dim)


def masked_moments(x: torch.Tensor, dim: int,
                   mask: Optional[torch.Tensor], group=None):
    """Per-channel mean and biased variance of x over all axes but `dim`,
    over the rows where `mask` is set; and the row count (>= 1).

    Under a process group these are the statistics of the rows of every
    rank of `group` (None: every rank; SyncBN, parallel/dist.py): the
    per-channel sums and the row count are all-reduced in one call, then
    the squared deviations from the global mean in a second one. Without
    a group the reductions are the identity, so one rank and N ranks run
    the same code."""
    dim = dim % x.dim()
    red = [i for i in range(x.dim()) if i != dim]
    shape = [1] * x.dim()
    shape[dim] = -1
    if mask is None:
        m = None
        n = torch.full((1,), float(x.numel() // x.shape[dim]),
                       dtype=x.dtype, device=x.device)
        s = torch.sum(x, dim=red)
    else:
        m = mask.to(x.dtype)
        n = torch.sum(m).reshape(1)
        s = torch.sum(x * m, dim=red)
    sn = dist.all_reduce_sum(torch.cat([s, n]), group)
    n = torch.clamp(sn[-1].detach(), min=1.0)
    mean = sn[:-1] / n
    diff = x - mean.reshape(shape)
    if m is not None:
        diff = diff * m
    return (mean, dist.all_reduce_sum(torch.sum(diff * diff, dim=red),
                                      group) / n, n)


def conv2d_oihw(x: torch.Tensor, w: torch.Tensor, b=None, padding=0,
                compute_dtype=torch.float32) -> torch.Tensor:
    """F.conv2d, in float32 or, with another compute_dtype, the JAX
    package's "mixed" conv (layers.conv2d): the operands rounded to
    compute_dtype, the conv run in it with an output rounded to it, that
    output back in x's dtype, then the bias added there."""
    if compute_dtype == torch.float32:
        return F.conv2d(x, w, b, padding=padding)
    y = F.conv2d(x.to(compute_dtype), w.to(compute_dtype),
                 padding=padding).to(x.dtype)
    return y if b is None else y + b.reshape(-1, 1, 1)


def conv2d_nchw(x: torch.Tensor, w_hwio: torch.Tensor, b=None,
                padding=None, compute_dtype=torch.float32) -> torch.Tensor:
    """NCHW conv with an HWIO weight, SAME padding for odd kernels unless
    `padding` is given (as F.conv2d takes it), in compute_dtype."""
    k = w_hwio.shape[0]
    return conv2d_oihw(x, w_hwio.permute(3, 2, 0, 1), b,
                       k // 2 if padding is None else padding, compute_dtype)


def conv2d(x: torch.Tensor, w_hwio: torch.Tensor, b=None,
           compute_dtype=torch.float32) -> torch.Tensor:
    """NHWC conv with an HWIO weight, SAME padding, stride 1, in
    compute_dtype (the JAX package's layers.conv2d)."""
    return conv2d_nchw(x.permute(0, 3, 1, 2), w_hwio, b,
                       compute_dtype=compute_dtype).permute(0, 2, 3, 1)


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
