"""Weighted, summed losses (the JAX package's ``core/losses.py``)."""
from __future__ import annotations

import torch


def _bce_with_logits(pred, target):
    return (torch.clamp(pred, min=0.0) - pred * target
            + torch.log1p(torch.exp(-torch.abs(pred))))


def sigmoid_focal_loss(pred, target, weight, gamma: float = 2.0,
                       alpha: float = 0.25):
    """sum(BCE_with_logits(pred, t) * (alpha t + (1-alpha)(1-t)) * pt^gamma
    * weight), pt = (1-p) t + p (1-t)."""
    p = torch.sigmoid(pred)
    target = target.to(pred.dtype)
    pt = (1.0 - p) * target + p * (1.0 - target)
    w = (alpha * target + (1.0 - alpha) * (1.0 - target)) * torch.pow(pt,
                                                                      gamma)
    return torch.sum(_bce_with_logits(pred, target) * (w * weight))


def smooth_l1_loss(pred, target, weight, beta: float = 1.0):
    diff = torch.abs(pred - target)
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)
    return torch.sum(loss * weight)


def softmax_cross_entropy(logits, labels, weight):
    """Weighted softmax CE over the last axis, summed; labels int."""
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    return torch.sum((logz - picked) * weight)


def binary_cross_entropy(pred, target, weight):
    return torch.sum(_bce_with_logits(pred, target) * weight)
