"""One-cycle AdamW with global-norm clipping (the JAX package's
``train/optim.py`` "adam_onecycle": ``optax.chain(clip_by_global_norm,
inject_hyperparams(adamw)(lr=one_cycle_lr, b1=one_cycle_momentum, b2=0.99,
eps=1e-8, mask=weight_decay_mask))``).

Per parameter p with clipped gradient g, at schedule count t (the number
of updates applied so far, read before the update as inject_hyperparams
reads it):

    mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
    u  = (mu / (1 - b1^(t+1))) / (sqrt(nu / (1 - b2^(t+1))) + eps)
    u += wd p   (decoupled decay, conv/linear kernels "w" only)
    p -= lr u

with b1 = b1(t), the current momentum, in the bias correction too. The
schedules are evaluated in float32, as the jitted JAX schedules are.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from sassd_tpu_torch.config import TrainConfig

_F = np.float32


def annealing_cos(start: float, end: float, pct) -> np.float32:
    """Cosine anneal from start (pct 0) to end (pct 1)."""
    cos_out = np.cos(_F(np.pi) * _F(pct)) + _F(1.0)
    return _F(end) + _F((start - end) / 2.0) * cos_out


def _phases(count: int, pct_start: float, total_steps: int):
    split = int(total_steps * pct_start)
    count = min(int(count), total_steps)
    return (count < split, _F(count) / _F(max(split, 1)),
            _F(count - split) / _F(max(total_steps - split, 1)))


def one_cycle_lr(lr_max: float, div_factor: float, pct_start: float,
                 total_steps: int) -> Callable[[int], np.float32]:
    """lr_max/div_factor -> lr_max over pct_start of the steps, then ->
    lr_max/div_factor/1e4."""
    low = lr_max / div_factor

    def schedule(count: int) -> np.float32:
        first, pct1, pct2 = _phases(count, pct_start, total_steps)
        return (annealing_cos(low, lr_max, pct1) if first
                else annealing_cos(lr_max, low / 1e4, pct2))
    return schedule


def one_cycle_momentum(moms: Tuple[float, float], pct_start: float,
                       total_steps: int) -> Callable[[int], np.float32]:
    """moms[0] -> moms[1] -> moms[0]: the inverse of the lr cycle."""
    def schedule(count: int) -> np.float32:
        first, pct1, pct2 = _phases(count, pct_start, total_steps)
        return (annealing_cos(moms[0], moms[1], pct1) if first
                else annealing_cos(moms[1], moms[0], pct2))
    return schedule


def weight_decay_mask(model: torch.nn.Module) -> Dict[str, bool]:
    """True for the parameters that receive weight decay: the conv and
    linear kernels (every "w" leaf); biases and BatchNorm scale/bias get
    none."""
    return {name: name.rsplit(".", 1)[-1] == "w"
            for name, _ in model.named_parameters()}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


class OneCycleAdamW:
    """The optimizer state (moments and count) of one model, and its
    update. Gradients are taken from the parameters' .grad (None = 0)."""

    B2 = 0.99
    EPS = 1e-8

    def __init__(self, model: torch.nn.Module, cfg: TrainConfig,
                 total_steps: int):
        self.params = dict(model.named_parameters())
        self.decay = weight_decay_mask(model)
        self.cfg = cfg
        self.lr = one_cycle_lr(cfg.lr, cfg.div_factor, cfg.pct_start,
                               total_steps)
        self.b1 = one_cycle_momentum(cfg.moms, cfg.pct_start, total_steps)
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}

    def grads(self) -> Dict[str, torch.Tensor]:
        return {k: p.grad if p.grad is not None else torch.zeros_like(p)
                for k, p in self.params.items()}

    def hyperparams(self) -> Tuple[float, float]:
        """(lr, b1) the next update applies."""
        return float(self.lr(self.count)), float(self.b1(self.count))

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor],
             gnorm: Optional[torch.Tensor] = None) -> None:
        """Clip the gradients to global norm cfg.grad_clip_norm and apply
        one update; `gnorm` is their global norm, if already computed."""
        max_norm = self.cfg.grad_clip_norm
        if gnorm is None:
            gnorm = global_norm(grads.values())
        clip = gnorm >= max_norm
        lr, b1 = self.lr(self.count), self.b1(self.count)
        t = self.count + 1
        bc1 = float(_F(1.0) - _F(b1) ** t)
        bc2 = float(_F(1.0) - _F(self.B2) ** t)
        wd = self.cfg.weight_decay
        for k, p in self.params.items():
            g = grads[k]
            g = torch.where(clip, g / gnorm * max_norm, g)
            mu = self.mu[k].mul_(float(b1)).add_(g * float(_F(1.0) - b1))
            nu = self.nu[k].mul_(self.B2).add_(
                g * g * float(_F(1.0) - _F(self.B2)))
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.EPS)
            if self.decay[k]:
                u = u + wd * p
            p.add_(u * -float(lr))
        self.count = t

    def state_dict(self) -> dict:
        return dict(count=self.count, mu=dict(self.mu), nu=dict(self.nu))

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for k in self.params:
            self.mu[k].copy_(state["mu"][k])
            self.nu[k].copy_(state["nu"][k])


def make_optimizer(model: torch.nn.Module, cfg: TrainConfig,
                   total_steps: int,
                   kind: str = "adam_onecycle") -> OneCycleAdamW:
    """The optimizer of `kind`; the port runs "adam_onecycle", the
    default of every configuration."""
    if kind != "adam_onecycle":
        raise NotImplementedError(f"optimizer kind {kind!r} is not ported")
    return OneCycleAdamW(model, cfg, total_steps)
