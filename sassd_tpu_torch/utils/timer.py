"""Profiling helpers (the JAX package's ``utils/timer.py``).

`TimeCatcher` times a region on the host clock with the card synchronised
on entry and exit (the reference's cuda-synchronised TimeCatcher), `trace`
records a region with torch.profiler and writes a Chrome trace (open it in
Perfetto or chrome://tracing), and `timeit` is the median host-clock time
of a synchronised call. Each takes the device the work runs on: the card
unless the caller asks for the CPU.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile


def _sync(device) -> None:
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class TimeCatcher:
    """with TimeCatcher('stage') as t: ... -- device-synchronised timing;
    t.elapsed holds the seconds."""

    def __init__(self, name: str = "", device="cuda", verbose: bool = True):
        self.name = name
        self.device = device
        self.verbose = verbose
        self.elapsed = None

    def __enter__(self):
        _sync(self.device)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync(self.device)
        self.elapsed = time.perf_counter() - self.t0
        if self.verbose:
            print(f"[{self.name}] {self.elapsed * 1e3:.2f} ms")
        return False


@contextlib.contextmanager
def trace(log_dir: str, device="cuda"):
    """Record the enclosed region with torch.profiler (the host, and the
    card's kernels when `device` is one) and write it to
    ``log_dir/trace.json`` as a Chrome trace. Yields the profiler."""
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _sync(device)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def timeit(fn, *args, warmup: int = 2, iters: int = 10,
           device="cuda") -> float:
    """Median host-clock seconds per call of fn(*args), the device
    synchronised around each call."""
    for _ in range(warmup):
        fn(*args)
    _sync(device)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
