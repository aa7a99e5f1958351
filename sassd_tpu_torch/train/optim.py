"""The optimizers of the JAX package's ``train/optim.py``: global-norm
clipping, then AdamW or SGD, with their schedules (optax's
``chain(clip_by_global_norm, inject_hyperparams(adamw | sgd)(...))``).

Kinds (:func:`make_optimizer`), as the JAX registry names them:

- "adam_onecycle" (every configuration's): AdamW, one-cycle cosine lr
  and inverse one-cycle b1, b2 0.99;
- "adam": AdamW at a constant lr, b1 0.9, b2 0.999;
- "adam_cosine": AdamW, lr cosine-annealed to 0 over the run, b1 0.9,
  b2 0.99;
- "sgd": momentum moms[0], constant lr, no weight decay.

The non-onecycle kinds take a half-cosine warmup prefix when
``warmup_iters`` > 0. AdamW, per parameter p with clipped gradient g, at
schedule count t (the updates applied so far, read before the update as
inject_hyperparams reads it):

    mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
    u  = (mu / (1 - b1^(t+1))) / (sqrt(nu / (1 - b2^(t+1))) + eps)
    u += wd p   (decoupled decay: conv/linear kernels "w" only, or with
                 weight_decay_mode="all" every parameter)
    p -= lr u

with b1 = b1(t) in the bias correction too. SGD: trace = g + m trace;
p -= lr trace. The schedules are evaluated in float32, as the jitted JAX
schedules are.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

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


def cosine_warmup(base_lr: float, warmup_iters: int, warmup_ratio: float,
                  after: Callable[[int], np.float32]
                  ) -> Callable[[int], np.float32]:
    """Half-cosine rise from base_lr * warmup_ratio to base_lr over the
    first warmup_iters steps, then `after`."""
    eta_min = _F(base_lr * warmup_ratio)

    def schedule(count: int) -> np.float32:
        if count >= warmup_iters:
            return after(count)
        pct = min(max(_F(count) / _F(max(warmup_iters, 1)), _F(0)), _F(1))
        return eta_min + (_F(base_lr) - eta_min) * (
            _F(1.0) - np.cos(_F(np.pi) * pct)) / _F(2.0)
    return schedule


def cosine_annealing(base_lr: float, total_steps: int
                     ) -> Callable[[int], np.float32]:
    """lr (1 + cos(pi t / T)) / 2 (torch's CosineAnnealingLR to 0)."""
    def schedule(count: int) -> np.float32:
        pct = min(max(_F(count) / _F(max(total_steps, 1)), _F(0)), _F(1))
        return _F(base_lr) * (_F(1.0) + np.cos(_F(np.pi) * pct)) / _F(2.0)
    return schedule


def constant(value: float) -> Callable[[int], np.float32]:
    return lambda count: _F(value)


def weight_decay_mask(model: torch.nn.Module) -> Dict[str, bool]:
    """True for the parameters that receive weight decay: the conv and
    linear kernels (every "w" leaf); biases and BatchNorm scale/bias get
    none."""
    return {name: name.rsplit(".", 1)[-1] == "w"
            for name, _ in model.named_parameters()}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


class _Clipped:
    """An optimizer's parameters, state (per-parameter moments and the
    count of applied updates) and its clipped update. Gradients are taken
    from the parameters' .grad (None = 0)."""

    MOMENTS: Tuple[str, ...] = ()

    def __init__(self, model: torch.nn.Module, cfg: TrainConfig):
        self.params = dict(model.named_parameters())
        self.cfg = cfg
        self.count = 0
        for m in self.MOMENTS:
            setattr(self, m, {k: torch.zeros_like(p)
                              for k, p in self.params.items()})

    def grads(self) -> Dict[str, torch.Tensor]:
        return {k: p.grad if p.grad is not None else torch.zeros_like(p)
                for k, p in self.params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor],
             gnorm: Optional[torch.Tensor] = None) -> None:
        """Clip the gradients to global norm cfg.grad_clip_norm and apply
        one update; `gnorm` is their global norm, if already computed."""
        max_norm = self.cfg.grad_clip_norm
        if gnorm is None:
            gnorm = global_norm(grads.values())
        clip = gnorm >= max_norm
        self._update({k: torch.where(clip, g / gnorm * max_norm, g)
                      for k, g in grads.items()})
        self.count += 1

    def state_dict(self) -> dict:
        out = dict(count=self.count)
        out.update({m: dict(getattr(self, m)) for m in self.MOMENTS})
        return out

    def load_state_dict(self, state: dict) -> None:
        """State as state_dict() gives it; the moments may be numpy
        arrays (a JAX checkpoint, train/jax_checkpoint.py)."""
        missing = [m for m in self.MOMENTS if m not in state]
        if missing:
            raise ValueError(f"optimizer state lacks {missing}")
        self.count = int(state["count"])
        for m in self.MOMENTS:
            src = state[m]
            if set(src) != set(self.params):
                raise ValueError(f"optimizer state {m!r} names other "
                                 f"parameters than the model's")
            for k, t in getattr(self, m).items():
                t.copy_(torch.as_tensor(src[k]))


class AdamW(_Clipped):
    """AdamW with an lr and a b1 schedule (callables of the count), a
    constant b2, eps 1e-8, and decoupled weight decay on the parameters
    `decay` names."""

    MOMENTS = ("mu", "nu")
    EPS = 1e-8

    def __init__(self, model: torch.nn.Module, cfg: TrainConfig,
                 lr: Callable[[int], np.float32],
                 b1: Callable[[int], np.float32], b2: float,
                 decay: Dict[str, bool]):
        super().__init__(model, cfg)
        self.lr, self.b1, self.b2, self.decay = lr, b1, b2, decay

    def hyperparams(self) -> Tuple[float, float]:
        """(lr, b1) the next update applies."""
        return float(self.lr(self.count)), float(self.b1(self.count))

    def _update(self, grads: Dict[str, torch.Tensor]) -> None:
        lr, b1, b2 = self.lr(self.count), self.b1(self.count), self.b2
        t = self.count + 1
        bc1 = float(_F(1.0) - _F(b1) ** t)
        bc2 = float(_F(1.0) - _F(b2) ** t)
        wd = self.cfg.weight_decay
        for k, p in self.params.items():
            g = grads[k]
            mu = self.mu[k].mul_(float(b1)).add_(g * float(_F(1.0) - b1))
            nu = self.nu[k].mul_(b2).add_(g * g * float(_F(1.0) - _F(b2)))
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.EPS)
            if self.decay[k]:
                u = u + wd * p
            p.add_(u * -float(lr))


class SGD(_Clipped):
    """SGD with momentum (optax.sgd: trace = g + m trace; p -= lr trace)
    and an lr schedule; no weight decay."""

    MOMENTS = ("trace",)

    def __init__(self, model: torch.nn.Module, cfg: TrainConfig,
                 lr: Callable[[int], np.float32], momentum: float):
        super().__init__(model, cfg)
        self.lr, self.momentum = lr, momentum

    def hyperparams(self) -> Tuple[float, float]:
        """(lr, momentum) the next update applies."""
        return float(self.lr(self.count)), float(_F(self.momentum))

    def _update(self, grads: Dict[str, torch.Tensor]) -> None:
        lr, m = self.lr(self.count), float(_F(self.momentum))
        for k, p in self.params.items():
            tr = self.trace[k].mul_(m).add_(grads[k])
            p.add_(tr * -float(lr))


Optimizer = Union[AdamW, SGD]


def make_optimizer(model: torch.nn.Module, cfg: TrainConfig,
                   total_steps: int, kind: str = "adam_onecycle"
                   ) -> Optimizer:
    """The optimizer of `kind` (see the module docstring) over
    `total_steps` updates, with the weight-decay scope of
    cfg.weight_decay_mode. Raises ValueError on an unknown kind or
    mode."""
    mode = cfg.weight_decay_mode
    if mode == "exclude_bn_bias":
        decay = weight_decay_mask(model)
    elif mode == "all":
        decay = {name: True for name, _ in model.named_parameters()}
    else:
        raise ValueError(f"unknown weight_decay_mode {mode!r}")

    def with_warmup(lr):
        if cfg.warmup_iters:
            return cosine_warmup(cfg.lr, cfg.warmup_iters, cfg.warmup_ratio,
                                 lr)
        return lr

    if kind == "adam_onecycle":
        return AdamW(model, cfg,
                     one_cycle_lr(cfg.lr, cfg.div_factor, cfg.pct_start,
                                  total_steps),
                     one_cycle_momentum(cfg.moms, cfg.pct_start,
                                        total_steps), 0.99, decay)
    if kind == "adam_cosine":
        return AdamW(model, cfg,
                     with_warmup(cosine_annealing(cfg.lr, total_steps)),
                     constant(0.9), 0.99, decay)
    if kind == "adam":
        return AdamW(model, cfg, with_warmup(constant(cfg.lr)),
                     constant(0.9), 0.999, decay)
    if kind == "sgd":
        return SGD(model, cfg, with_warmup(constant(cfg.lr)), cfg.moms[0])
    raise ValueError(f"unknown optimizer kind {kind!r}")
