"""Where the time goes: car-config inference on one GPU under torch.profiler.

    python -m sassd_tpu_torch.profile_slice [--batch 1] [--device-plans | --serve]

Runs forward_test on synthetic car-config scans (seeded weights, as
chip_smoke.py), with the C++ host rulebook or, with --device-plans
(model.host_plans=False), the rulebook built on the card, or, with
--serve, the device-resident serving step (serve.make_serving_step: raw
points uploaded, voxelized, masked and the rulebook built on the card);
then profiles RUNS steps and prints: the host-clock step time, the device
time of each stage (voxelize, anchors_mask, rulebook, vxnet, bevnet, head,
pswarp, nms), the CUDA kernels with the most device time, and the device
busy share of the profiled window. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from sassd_tpu_torch import serve
from sassd_tpu_torch.config import car_config
from sassd_tpu_torch.data import kitti, synthetic
from sassd_tpu_torch.inference import make_test_step
from sassd_tpu_torch.weights import seeded_detector

STAGES = ("voxelize", "anchors_mask", "rulebook", "vxnet", "bevnet", "head",
          "pswarp", "nms")
RUNS = 8
SEED = 0


def _stage_table(prof, runs: int) -> str:
    """Per stage: its span on the device timeline (first kernel start to
    last kernel end) and the device time of the kernels and copies that
    start inside it, ms/step. Kernels are matched by time, not by the
    CPU-side range: the hand kernels launch through ctypes, outside any
    torch op, so the profiler does not attribute them to a range."""
    gpu = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    work = [(e.time_range.start, e.time_range.end) for e in gpu
            if e.name not in STAGES]
    out = []
    for stage in STAGES:
        ranges = [e.time_range for e in gpu if e.name == stage]
        if not ranges:
            continue
        span = sum(r.end - r.start for r in ranges)
        busy = sum(t - s for s, t in work for r in ranges
                   if r.start <= s < r.end)
        out.append(f"{stage} kernels {busy / runs / 1e3:.3f} / span "
                   f"{span / runs / 1e3:.3f}")
    return "; ".join(out)


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
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--device-plans", action="store_true",
                      help="build the rulebook on the card "
                           "(host_plans=False)")
    mode.add_argument("--serve", action="store_true",
                      help="serve raw points (test.device_input='points')")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    cfg = car_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, host_plans=not args.device_plans))
    anchors, anchors_bv = kitti.build_anchors(cfg)
    model = seeded_detector(cfg, SEED, device)
    rng = np.random.default_rng(SEED)
    scans = [synthetic.make_scene(rng, n_cars=(6, 12), n_ground=18000)[0]
             for _ in range(args.batch)]
    if args.serve:
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
            "device plans" if args.device_plans else "host plans")
    print(f"{torch.cuda.get_device_name(0)}, batch {args.batch}, {what}: "
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
