"""Weights of the JAX package's detector <-> the port's Detector.

The JAX detector keeps trainable leaves in a ``params`` tree and BatchNorm
statistics in a ``state`` tree of the same nesting. The port names every
parameter and buffer by that nesting, so ``params["vxnet"]["conv0"]
["conv0"]["w"]`` is the parameter ``vxnet.conv0.conv0.w`` and ``state
["bevnet"]["bn0"]["mean"]`` the buffer ``bevnet.bn0.mean``; layouts are
the same (conv HWIO, sparse conv [27, Cin, Cout]).

Only the inference modules are carried: the training-only ``aux`` point
branch is dropped.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from sassd_tpu_torch.config import SASSDConfig
from sassd_tpu_torch.models.detector import Detector

MODULES = ("vxnet", "bevnet", "head", "pswarp")
# He's variance-preserving gain for ReLU nets over the U(+-1/sqrt(fan_in))
# init, which keeps seeded activations from collapsing (see seeded_detector).
RELU_GAIN = 6.0 ** 0.5


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def load_jax(model: Detector, params: dict, state: dict) -> Detector:
    """Copy JAX params/state (nested dicts of arrays) into `model`."""
    flat = {}
    for tree in (params, state):
        flat.update(_flatten({k: tree[k] for k in MODULES if k in tree}))
    model.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                           for k, v in flat.items()}, strict=True)
    return model


def from_jax(cfg: SASSDConfig, params: dict, state: dict,
             device="cpu") -> Detector:
    """A Detector holding the given JAX weights, on `device`."""
    return load_jax(Detector(cfg), params, state).to(device)


def seeded_detector(cfg: SASSDConfig, seed: int, device="cpu") -> Detector:
    """Random weights from `seed`, every conv weight scaled by RELU_GAIN.

    With the plain U(+-1/sqrt(fan_in)) init each conv shrinks activations
    ~2.4x and the trunk's output collapses (the BEV map's std is 1.4e-13 in
    tests/golden_detections.npz), so every score ties at 0.5 and smoke or
    timing runs would compare and time degenerate outputs.
    """
    model = Detector(cfg, torch.Generator().manual_seed(seed))
    sd = model.state_dict()
    for name, t in sd.items():
        if name.endswith(".w"):
            t.mul_(RELU_GAIN)
    model.load_state_dict(sd)                 # rebuilds derived weights
    return model.to(device)


def to_jax(model: Detector) -> Tuple[dict, dict]:
    """The model's weights as JAX-style (params, state) numpy trees."""
    params = {k: v.detach().cpu().numpy()
              for k, v in model.named_parameters()}
    state = {k: v.detach().cpu().numpy()
             for k, v in model.named_buffers()
             if k.rsplit(".", 1)[-1] in ("mean", "var")}
    return _unflatten(params), _unflatten(state)
