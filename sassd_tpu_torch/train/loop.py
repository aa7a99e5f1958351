"""Training: the train step with its non-finite guard, log averaging,
and the epoch loop with checkpoints and resume (the JAX package's
``train/loop.py``), on one device or data-parallel over a process group.

A step: host batch -> device -> ``Detector.forward_train`` -> the summed
losses -> backward (K4, K10, K5b, K11, K3b on the card) -> global-norm
clip + the optimizer (one-cycle AdamW unless another kind is made,
train/optim.py). It marks ``backward`` and ``optimizer`` with
torch.profiler ranges (see sassd_tpu_torch/profile_slice.py).

Data-parallel (a process group up, parallel/dist.py): each of N ranks
holds a replica and takes a strided 1/N of every global batch. The step
keeps the semantics of the JAX step over the global batch: BatchNorm
takes global statistics and the losses global normalizers (so each
rank's loss is its share of the global loss), and after the backward one
coalesced SUM all-reduce gives every rank the global gradient and the
global losses; the clip, the guard and AdamW then run alike on every
rank. The reductions hand every rank the same bits (each element is
summed once and the result copied), so the replicas stay bitwise equal
without a broadcast (tests/test_torch_multiprocess.py and chip_smoke.py
phase 10 check it). DistributedDataParallel is not used: it averages the
gradients (the sum is wanted, before the clip) and broadcasts the
BatchNorm buffers, which SyncBN keeps equal already.

Across spatial ranks (``parallel.strategy`` "spatial" or "banded" with S
= ``parallel.spatial`` > 1, parallel/mesh.py) the ranks of a data row take
the same shard of each global batch, which must divide by the data axis's
W / S rows, and split its BEV canvas or its bands; forward_train scales
what every rank of a row computes whole by 1 / S, so the same SUM over
every rank gives the global gradient and losses.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from sassd_tpu_torch.config import SASSDConfig, check_supported
from sassd_tpu_torch.data.loader import iterate_batches
from sassd_tpu_torch.inference import to_device
from sassd_tpu_torch.models.detector import Detector, parse_losses
from sassd_tpu_torch.parallel import dist, mesh
from . import checkpoint as ckpt_lib
from . import optim as optim_lib


def make_train_step(cfg: SASSDConfig, anchors: np.ndarray,
                    optimizer: optim_lib.Optimizer, device
                    ) -> Callable[[Detector, Dict[str, np.ndarray]],
                                  Dict[str, torch.Tensor]]:
    """Returns step(model, batch) -> metrics (device scalars): every
    forward_train entry, loss (the objective), grad_norm and
    nonfinite_skips.

    Under a process group `batch` is this rank's data row's slice of the
    global batch; the metrics are the global batch's (losses and
    guided_valid / guided_pos summed over the ranks, guided_truncated
    averaged over the data rows) and the parameters' .grad hold the
    global gradient after the step.

    When the gradient norm or any loss is not finite, the update is
    skipped whole: parameters, BatchNorm running buffers and optimizer
    moments keep their values, and nonfinite_skips is 1. The check reads
    one scalar from the device per step.
    """
    check_supported(cfg, train=True)
    anchors_t = torch.from_numpy(np.asarray(anchors, np.float32)).to(device)
    data_rows = mesh.layout(cfg).data

    def step(model: Detector, batch: Dict[str, np.ndarray]):
        model.train()
        buffers = [b for n, b in model.named_buffers()
                   if n.rsplit(".", 1)[-1] in ("mean", "var")]
        saved = [b.clone() for b in buffers]
        losses = model.forward_train(to_device(batch, device), anchors_t)
        total = parse_losses(losses)
        for p in optimizer.params.values():
            p.grad = None
        with record_function("backward"):
            total.backward()
        with record_function("optimizer"):
            grads = optimizer.grads()
            values = torch.stack([v.detach() for v in losses.values()])
            dist.all_reduce_coalesced(list(grads.values()) + [values])
            metrics = dict(zip(losses, values))
            if "guided_truncated" in metrics:
                metrics["guided_truncated"] = (metrics["guided_truncated"]
                                               / data_rows)
            gnorm = optim_lib.global_norm(grads.values())
            ok = torch.isfinite(gnorm) & torch.isfinite(
                sum(torch.sum(v) for v in metrics.values()))
            if bool(ok):
                optimizer.step(grads, gnorm)
            else:
                with torch.no_grad():
                    for b, s in zip(buffers, saved):
                        b.copy_(s)
        metrics["loss"] = parse_losses(metrics)
        metrics["grad_norm"] = gnorm.detach()
        metrics["nonfinite_skips"] = (~ok).to(torch.float32)
        return metrics
    return step


class LogBuffer:
    """Running averages of the step metrics between two log lines. The
    sums stay on the device; averages() reads them once."""

    def __init__(self):
        self.sums: Dict[str, torch.Tensor] = {}
        self.counts: Dict[str, int] = {}

    def update(self, metrics: Dict[str, torch.Tensor]) -> None:
        for k, v in metrics.items():
            self.sums[k] = v if k not in self.sums else self.sums[k] + v
            self.counts[k] = self.counts.get(k, 0) + 1

    def averages(self) -> Dict[str, float]:
        return {k: float(v) / max(self.counts[k], 1)
                for k, v in self.sums.items()}

    def clear(self) -> None:
        self.sums.clear()
        self.counts.clear()


def train_model(cfg: SASSDConfig, dataset, work_dir: Optional[str] = None,
                *, total_epochs: Optional[int] = None, device="cuda",
                logger: Optional[logging.Logger] = None,
                resume: bool = True,
                epoch_callback: Optional[Callable] = None,
                eval_interval: Optional[int] = None,
                epochs_per_run: Optional[int] = None
                ) -> Tuple[Detector, optim_lib.Optimizer, int]:
    """Train a Detector from its seeded initialisation (cfg.train.seed) on
    `dataset` (a KittiDataset with train=True). Returns (model, optimizer,
    final step).

    work_dir defaults to cfg.work_dir. The one-cycle schedule spans
    total_epochs (default cfg.train.total_epochs) of ceil(len(dataset) /
    batch_size) steps. Start: with cfg.load_from,
    the parameters of that checkpoint (.pt or JAX .msgpack; BatchNorm
    statistics stay as initialised); then, with cfg.resume_from, or else
    with `resume` and a checkpoint in work_dir, the newest one, the whole
    state is restored: after an end-of-epoch save the run continues at
    the next epoch, after a mid-epoch save it fast-forwards the same
    epoch's batch order. epochs_per_run: stop this call after that many
    epochs while the schedule stays pinned to total_epochs (a relaunch
    resumes; the train CLI exits 75 while epochs remain).

    Checkpoints are written every cfg.train.checkpoint_interval epochs
    and after the call's last epoch, and every
    cfg.train.checkpoint_every_steps steps inside an epoch when that is
    set. epoch_callback(epoch, model) runs after every eval_interval-th
    epoch (every epoch by default).

    Under a process group of N ranks (parallel/dist.py) each rank calls
    this with its own `device` (mesh.local_device()) and the same
    `work_dir`: cfg.train.batch_size is the global batch and must divide
    by the D = N / S data rows (S spatial ranks a row, parallel/mesh.py;
    S = 1 but for the spatial strategies), each rank loads its row's
    strided 1/D of every global batch, the step reduces over the ranks,
    and rank 0 alone writes checkpoints, every rank waiting at a barrier
    after each save. Every rank resumes from the shared work_dir.
    """
    check_supported(cfg, train=True)
    logger = logger or logging.getLogger("sassd")
    work_dir = work_dir or cfg.work_dir
    tc = cfg.train
    total_epochs = total_epochs or tc.total_epochs
    bs = tc.batch_size
    num_shards, shard_id = mesh.host_shard_info(cfg)
    if bs % num_shards:
        raise ValueError(f"global batch_size {bs} not divisible by the "
                         f"{num_shards} data rows of "
                         f"{dist.process_count()} processes")
    local_bs = bs // num_shards
    # the loader pads each epoch to a multiple of the global batch, so
    # every rank takes ceil(N / bs) steps
    steps_per_epoch = max(-(-len(dataset) // bs), 1)
    total_steps = steps_per_epoch * total_epochs

    model = Detector(cfg, torch.Generator().manual_seed(tc.seed)).to(device)
    optimizer = optim_lib.make_optimizer(model, tc, total_steps)
    start_epoch, step, start_batch = 0, 0, 0
    if cfg.load_from:
        ckpt_lib.load_params_only(cfg.load_from, model)
        logger.info("loaded parameters from %s", cfg.load_from)
    path = cfg.resume_from or (ckpt_lib.latest_checkpoint(work_dir)
                               if resume else None)
    if path:
        start_epoch, step, bidx = ckpt_lib.restore(path, model, optimizer)
        if bidx >= 0:
            start_batch = bidx
        else:
            start_epoch += 1
        logger.info("resumed from %s (epoch %d, step %d, batch %d)", path,
                    start_epoch, step, start_batch)
    end_epoch = total_epochs
    if epochs_per_run is not None:
        end_epoch = min(total_epochs, start_epoch + epochs_per_run)

    def save(epoch: int, **kw) -> None:
        if dist.is_primary():      # replicas are equal; one writer
            logger.info("saved %s", ckpt_lib.save(
                work_dir, epoch, step, model, optimizer,
                max_keep=tc.max_ckpt_keep, **kw))
        dist.barrier(f"ckpt_step_{step}")

    train_step = make_train_step(cfg, dataset.anchors, optimizer, device)
    buf = LogBuffer()
    every = tc.checkpoint_every_steps
    for epoch in range(start_epoch, end_epoch):
        t0 = time.time()
        bidx = start_batch
        warned = False
        for batch, _metas in iterate_batches(
                dataset, local_bs, epoch=epoch, seed=tc.seed, shuffle=True,
                num_shards=num_shards, shard_id=shard_id,
                num_workers=cfg.data.num_workers, start_batch=start_batch):
            buf.update(train_step(model, batch))
            step += 1
            bidx += 1
            if every and bidx < steps_per_epoch and step % every == 0:
                save(epoch, batch_idx=bidx)
            if step % tc.log_interval == 0:
                avg = buf.averages()
                lr, mom = optimizer.hyperparams()
                logger.info("epoch %d step %d lr %.5f mom %.3f %s", epoch,
                            step, lr, mom, " ".join(
                                f"{k}={v:.4f}" for k, v in sorted(avg.items())))
                # the reference keeps every anchor passing the score
                # threshold; the guided cap drops the rest
                if avg.get("guided_truncated", 0.0) > 0.5 and not warned:
                    warned = True
                    logger.warning(
                        "guided-anchor truncation: %.1f anchors/sample "
                        "dropped by caps.guided_train=%d this window",
                        avg["guided_truncated"], cfg.caps.guided_train)
                buf.clear()
        start_batch = 0
        logger.info("epoch %d done in %.1fs", epoch, time.time() - t0)
        if ((epoch + 1) % tc.checkpoint_interval == 0
                or epoch == end_epoch - 1):
            save(epoch)
        if (epoch_callback is not None
                and (epoch + 1) % (eval_interval or 1) == 0):
            epoch_callback(epoch, model)
    return model, optimizer, step
