"""Checkpoints of a training run: save, list, restore, rolling window.

One file per checkpoint, ``checkpoint_epoch_{E}.pt`` after a finished
epoch or ``checkpoint_epoch_{E}_step_{B}.pt`` after B batches of epoch E,
holding the model's state dict (parameters and BatchNorm buffers), the
optimizer state, the epoch, the step and the batch index, in torch's own
format (loaded with ``weights_only=True``). The newest ``max_keep`` are
kept; a mid-epoch file is dropped as soon as a later checkpoint exists.

:func:`restore` and :func:`load_params_only` also read the ``.msgpack``
checkpoints of the JAX package (train/jax_checkpoint.py): parameters and
BatchNorm statistics by the names of ``weights.py``, and optax's AdamW or
SGD state onto the port's optimizer.
"""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import List, Optional, Tuple

import torch

from sassd_tpu_torch import weights
from . import jax_checkpoint

_NAME = re.compile(r"checkpoint_epoch_(\d+)(?:_step_(\d+))?\.pt$")
_END_OF_EPOCH = 1 << 30


def _sort_key(path: str):
    """Chronological order: mid-epoch saves of epoch E precede its
    end-of-epoch save."""
    m = _NAME.search(path)
    batch = int(m.group(2)) if m.group(2) else _END_OF_EPOCH
    return (int(m.group(1)), batch)


def list_checkpoints(work_dir: str) -> List[str]:
    """The run's checkpoint files, oldest first."""
    paths = [str(p) for p in Path(work_dir).glob("checkpoint_epoch_*.pt")
             if _NAME.search(str(p))]
    return sorted(paths, key=_sort_key)


def latest_checkpoint(work_dir: str) -> Optional[str]:
    ckpts = list_checkpoints(work_dir)
    return ckpts[-1] if ckpts else None


def write(path: str, model, optimizer, epoch: int, step: int,
          batch_idx: int = -1) -> None:
    """Write one checkpoint file (atomically: a temporary file renamed).
    `optimizer` None writes no optimizer state (an imported model)."""
    to_cpu = lambda t: t.detach().cpu()  # noqa: E731
    opt = {} if optimizer is None else {
        k: ({n: to_cpu(t) for n, t in v.items()} if isinstance(v, dict)
            else v) for k, v in optimizer.state_dict().items()}
    payload = dict(
        model={k: to_cpu(v) for k, v in model.state_dict().items()},
        optimizer=opt, epoch=int(epoch), step=int(step),
        batch_idx=int(batch_idx))
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save(work_dir: str, epoch: int, step: int, model, optimizer,
         max_keep: int = 10, batch_idx: Optional[int] = None) -> str:
    """Write a checkpoint and prune old ones. batch_idx: a mid-epoch save
    after that many batches of `epoch` (resume restarts the epoch there);
    without it the epoch is complete (resume starts at epoch + 1)."""
    Path(work_dir).mkdir(parents=True, exist_ok=True)
    name = (f"checkpoint_epoch_{epoch}.pt" if batch_idx is None
            else f"checkpoint_epoch_{epoch}_step_{batch_idx}.pt")
    path = str(Path(work_dir) / name)
    write(path, model, optimizer, epoch, step,
          -1 if batch_idx is None else batch_idx)

    ckpts = list_checkpoints(work_dir)
    latest = _sort_key(ckpts[-1])
    stale = [p for p in ckpts if _sort_key(p)[1] != _END_OF_EPOCH
             and _sort_key(p) != latest and p != path]
    for p in stale:
        os.remove(p)
    ckpts = [p for p in ckpts if p not in stale]
    for p in ckpts[:-max_keep]:
        if p != path:
            os.remove(p)
    return path


def is_jax_checkpoint(path: str) -> bool:
    return str(path).endswith(".msgpack")


def restore(path: str, model, optimizer=None) -> Tuple[int, int, int]:
    """Load a checkpoint, the port's ``.pt`` or the JAX package's
    ``.msgpack``, into `model` (parameters and BatchNorm statistics) and
    `optimizer` (moments and count); returns (epoch, step, batch_idx),
    batch_idx -1 for an end-of-epoch checkpoint. Raises ValueError when
    `optimizer` is given and the file holds no optimizer state (an
    imported reference checkpoint)."""
    if is_jax_checkpoint(path):
        payload = jax_checkpoint.read(path)
        weights.load_jax(model, payload["params"], payload["state"])
        if optimizer is not None:
            optimizer.load_state_dict(jax_checkpoint.optimizer_state(
                payload.get("opt_state", {})))
        return (int(payload["epoch"]), int(payload["step"]),
                int(payload.get("batch_idx", -1)))
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(payload["model"])
    if optimizer is not None:
        if not payload["optimizer"]:
            raise ValueError(f"{path} holds no optimizer state")
        optimizer.load_state_dict(payload["optimizer"])
    return (int(payload["epoch"]), int(payload["step"]),
            int(payload["batch_idx"]))


def load_params_only(path: str, model) -> None:
    """Copy the parameters of a checkpoint (``.pt`` or JAX ``.msgpack``)
    into `model`, for fine-tuning (cfg.load_from). BatchNorm statistics
    keep the model's values. Raises when the file lacks a parameter of
    the model or names one the model does not have."""
    if is_jax_checkpoint(path):
        tree = jax_checkpoint.read(path)["params"]
        flat = weights._flatten({k: tree[k] for k in weights.MODULES
                                 if k in tree})
        params = {k: torch.from_numpy(v.astype("float32"))
                  for k, v in flat.items()}
    else:
        sd = torch.load(path, map_location="cpu",
                        weights_only=True)["model"]
        buffers = dict(model.named_buffers())
        params = {k: v for k, v in sd.items() if k not in buffers}
    names = set(dict(model.named_parameters()))
    missing, unexpected = names - set(params), set(params) - names
    if missing or unexpected:
        raise KeyError(f"{path}: parameters missing {sorted(missing)[:8]}, "
                       f"unexpected {sorted(unexpected)[:8]}")
    # through load_state_dict, so derived weights (VxNet's dense-tail
    # weights) are rebuilt from the new parameters
    model.load_state_dict(params, strict=False)
