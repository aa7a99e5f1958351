"""Where the time goes: inference or training on one GPU under
torch.profiler.

    python -m sassd_tpu_torch.profile_slice [--batch 1]
        [--config car|multi|long_range] [--device-plans | --serve | --banded]
        [--train [--exact]]

Runs forward_test on synthetic scans (seeded weights, as chip_smoke.py)
of the car config or, with --config multi, the three-class config, or,
with --config long_range, the long-range config (0-102.4 m; frustum scans
with far-field returns, ~70,000 voxels, as chip_smoke.py's timing scan),
with the C++ host rulebook or, with --device-plans (model.host_plans=False),
the rulebook built on the card, or, with --serve, the device-resident
serving step (serve.make_serving_step: raw points uploaded, voxelized,
masked and the rulebook built on the card), or, with --banded, the banded
sparse stage over 4 y-bands (parallel.strategy="banded"; the partition,
the band rulebook and VxNet on the card), or, with --train, the train
step (train.loop.make_train_step on the scans and their GT boxes:
forward_train, backward, one-cycle AdamW; with --device-plans the card
builds the train rulebook inside the step, with --exact the aux branch
takes the exact 3-NN); then profiles RUNS steps and prints: the host-clock step time, the
device time of each stage (voxelize, anchors_mask, partition, rulebook,
vxnet, bevnet, aux, head, targets_losses, pswarp, nms, backward,
optimizer), the
CUDA kernels with the most device time, and the device busy share of the
profiled window. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Tuple

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from sassd_tpu_torch import serve
from sassd_tpu_torch.config import (ParallelConfig, car_config,
                                    long_range_config, multi_config)
from sassd_tpu_torch.data import kitti, synthetic
from sassd_tpu_torch.inference import make_test_step
from sassd_tpu_torch.train import loop, optim
from sassd_tpu_torch.weights import seeded_detector

STAGES = ("voxelize", "anchors_mask", "partition", "rulebook", "vxnet",
          "bevnet", "aux", "head", "targets_losses", "pswarp", "nms",
          "backward", "optimizer")
RUNS = 8
SEED = 0


def stage_times(prof, runs: int) -> Dict[str, Tuple[float, float]]:
    """Per stage that ran: (the device time of the kernels and copies that
    start inside its span, its span on the device timeline: first kernel
    start to last kernel end), ms/step. Kernels are matched by time, not by
    the CPU-side range: the hand kernels launch through ctypes, outside any
    torch op, so the profiler does not attribute them to a range. The
    autograd engine runs the backward on its own thread, outside the
    "backward" range, so that stage is the window from the end of each
    step's pswarp stage to the start of its optimizer stage."""
    gpu = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    work = [(e.time_range.start, e.time_range.end) for e in gpu
            if e.name not in STAGES]
    spans = {stage: sorted((e.time_range.start, e.time_range.end)
                           for e in gpu if e.name == stage)
             for stage in STAGES}
    if spans["pswarp"] and len(spans["pswarp"]) == len(spans["optimizer"]):
        spans["backward"] = [(p[1], o[0]) for p, o in
                             zip(spans["pswarp"], spans["optimizer"])]
    out = {}
    for stage in STAGES:
        ranges = spans[stage]
        if not ranges:
            continue
        span = sum(t - s for s, t in ranges)
        busy = sum(t - s for s, t in work for r in ranges
                   if r[0] <= s < r[1])
        out[stage] = (busy / runs / 1e3, span / runs / 1e3)
    return out


def _stage_table(prof, runs: int) -> str:
    """stage_times as one line."""
    return "; ".join(f"{stage} kernels {busy:.3f} / span {span:.3f}"
                     for stage, (busy, span) in stage_times(prof,
                                                            runs).items())


def _busy_us(prof) -> float:
    """Union of the device intervals of kernels and copies."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and e.name not in STAGES)
    busy, cur_s, cur_e = 0.0, None, None
    for s, t in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--config", choices=("car", "multi", "long_range"),
                    default="car",
                    help="car_config(), the three-class multi_config() or "
                         "long_range_config()")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--device-plans", action="store_true",
                      help="build the rulebook on the card "
                           "(host_plans=False)")
    mode.add_argument("--serve", action="store_true",
                      help="serve raw points (test.device_input='points')")
    mode.add_argument("--banded", action="store_true",
                      help="the banded sparse stage over 4 y-bands "
                           "(parallel.strategy='banded')")
    ap.add_argument("--train", action="store_true",
                    help="the train step (forward_train, backward, AdamW)")
    ap.add_argument("--exact", action="store_true",
                    help="with --train: the exact aux 3-NN "
                         "(aux_interp='exact')")
    args = ap.parse_args()
    if args.train and args.serve:
        ap.error("--train runs on host or device plans, not --serve")
    if args.exact and not args.train:
        ap.error("--exact needs --train")
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    cfg = dict(car=car_config, multi=multi_config,
               long_range=long_range_config)[args.config]()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, host_plans=not args.device_plans,
        aux_interp="exact" if args.exact else "ring"))
    if args.banded:
        cfg = dataclasses.replace(cfg, parallel=ParallelConfig(
            strategy="banded", spatial=4))
    anchors, anchors_bv = kitti.build_anchors(cfg)
    model = seeded_detector(cfg, SEED, device)
    rng = np.random.default_rng(SEED)
    if args.config == "long_range":
        scenes = [synthetic.long_range_scene(rng, classes=cfg.class_names)
                  for _ in range(args.batch)]
    else:
        scenes = [synthetic.make_scene(rng, n_cars=(6, 12), n_ground=18000,
                                       classes=cfg.class_names)
                  for _ in range(args.batch)]
    scans = [p for p, _, _ in scenes]
    if args.train:
        samples = []
        for p, bx, types in scenes:
            s = kitti.prepare_scan(cfg, p, anchors_bv, train=True)
            g = cfg.caps.max_gt
            s["gt_boxes"] = np.zeros((g, 7), np.float32)
            s["gt_boxes"][:len(bx)] = bx[:g]
            s["gt_valid"] = np.arange(g) < len(bx)
            s["gt_classes"] = np.zeros((g,), np.int32)
            s["gt_classes"][:len(bx)] = [cfg.class_names.index(t) + 1
                                         for t in types[:g]]
            samples.append(s)
        batch = kitti.collate(samples)[0]
        step = loop.make_train_step(
            cfg, anchors, optim.make_optimizer(model, cfg.train, 1000),
            device)
    elif args.serve:
        prepared = [serve.prepare_points(p, cfg) for p in scans]
        batch = dict(points=np.stack([p for p, _ in prepared]),
                     n_points=np.asarray([n for _, n in prepared], np.int32))
        step = serve.make_serving_step(cfg, anchors, anchors_bv, device)
    else:
        batch = kitti.collate([kitti.prepare_scan(cfg, p, anchors_bv)
                               for p in scans])[0]
        step = make_test_step(cfg, anchors, device)
    for _ in range(3):
        step(model, batch)
    torch.cuda.synchronize()

    t = time.perf_counter()
    for _ in range(RUNS):
        step(model, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / RUNS

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        t = time.perf_counter()
        for _ in range(RUNS):
            step(model, batch)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t) * 1e6
    events = prof.key_averages()

    what = ("serving from raw points" if args.serve else
            "banded, 4 bands" if args.banded else
            "device plans" if args.device_plans else "host plans")
    if args.train:
        what = f"training on {what}, {cfg.model.aux_interp} aux"
    print(f"{torch.cuda.get_device_name(0)}, {args.config} config, batch "
          f"{args.batch}, {what}: "
          f"{step_ms:.2f} ms/step unprofiled (host clock, synced)")
    print("stage ms/step: " + _stage_table(prof, RUNS))
    busy_us = _busy_us(prof)
    print(f"device busy {busy_us / RUNS / 1e3:.2f} ms/step of "
          f"{window_us / RUNS / 1e3:.2f} ms/step profiled "
          f"({100 * busy_us / window_us:.1f}% busy)")
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA
                      and e.key not in STAGES),
                     key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:20]:
        print(f"  {e.self_device_time_total / RUNS / 1e3:8.3f} ms/step "
              f"x{e.count // RUNS:<4d} {e.key[:100]}")


if __name__ == "__main__":
    main()
