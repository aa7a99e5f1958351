"""Checkpoints of a training run: save, list, restore, rolling window.

One file per checkpoint, ``checkpoint_epoch_{E}.pt`` after a finished
epoch or ``checkpoint_epoch_{E}_step_{B}.pt`` after B batches of epoch E,
holding the model's state dict (parameters and BatchNorm buffers), the
optimizer state, the epoch, the step and the batch index, in torch's own
format (loaded with ``weights_only=True``). The newest ``max_keep`` are
kept; a mid-epoch file is dropped as soon as a later checkpoint exists.
"""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import List, Optional, Tuple

import torch

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


def save(work_dir: str, epoch: int, step: int, model, optimizer,
         max_keep: int = 10, batch_idx: Optional[int] = None) -> str:
    """Write a checkpoint and prune old ones. batch_idx: a mid-epoch save
    after that many batches of `epoch` (resume restarts the epoch there);
    without it the epoch is complete (resume starts at epoch + 1)."""
    Path(work_dir).mkdir(parents=True, exist_ok=True)
    to_cpu = lambda t: t.detach().cpu()  # noqa: E731
    opt = optimizer.state_dict()
    payload = dict(
        model={k: to_cpu(v) for k, v in model.state_dict().items()},
        optimizer=dict(count=opt["count"],
                       mu={k: to_cpu(v) for k, v in opt["mu"].items()},
                       nu={k: to_cpu(v) for k, v in opt["nu"].items()}),
        epoch=int(epoch), step=int(step),
        batch_idx=-1 if batch_idx is None else int(batch_idx))
    name = (f"checkpoint_epoch_{epoch}.pt" if batch_idx is None
            else f"checkpoint_epoch_{epoch}_step_{batch_idx}.pt")
    path = str(Path(work_dir) / name)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)

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


def restore(path: str, model, optimizer=None) -> Tuple[int, int, int]:
    """Load a checkpoint into `model` (and `optimizer`); returns (epoch,
    step, batch_idx), batch_idx -1 for an end-of-epoch checkpoint."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(payload["model"])
    if optimizer is not None:
        optimizer.load_state_dict(payload["optimizer"])
    return (int(payload["epoch"]), int(payload["step"]),
            int(payload["batch_idx"]))
