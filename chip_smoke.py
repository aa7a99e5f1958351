#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sassd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card, nvcc and g++.
Phases, each of which fails the run (nonzero exit, no result line):

1. environment: torch/CUDA versions, the card, its power limit, nvcc;
2. build: the C++ host library (g++) and the CUDA kernels (nvcc), timed;
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the shapes of the car-config path, with stated tolerances,
   and both timed with CUDA events. K4 (sparse conv, at the sparse
   ladder's 10 convs, each with its found-slot fraction and bound) and K5
   (dense-tail scatter) run on the host plans of synthetic car scans; K6
   (index maps + window plans) and K7 (downsample) build the device
   rulebook of those scans, which must equal both the plain versions and
   the C++ host rulebook bit for bit;
4. host plans: car-config inference (full widths, random weights from a
   seed) over 4 synthetic scans at batch 1 and once at batch 2, with the
   launch counters reset just before and read just after; K1-K5 must have
   launched, detections must be finite, the batch-2 run must agree with
   the batch-1 runs, and one scan run on the CPU (plain versions) must
   agree with the card;
5. device plans (model.host_plans=False): the same scans and checks, the
   rulebook built on the card; K1-K7 must have launched, and every scan's
   detections must match the host-plans phase's;
6. serving (test.device_input="points"): a 4-scan synthetic KITTI val
   split (frustum scans at car range) written to a temporary directory,
   run_inference over it at batch 1 and batch 2 with the launch counters
   reset just before and read just after; K1-K9 must have launched. On
   every scan whose in-range voxel count is under the cap, the detections
   must match the host-input (device_input="voxels") run's and batch 2's
   must match batch 1's; one scan served on the CPU (plain versions) must
   match the card. The result files are written, evaluate's KITTI AP table
   is printed, and the serving step is timed with the raw-points upload
   inside the clock.

7. training: a 4-scan car-range synthetic KITTI train split; one
   forward_train + backward at batch 2 on the card against the same on
   the CPU (plain versions): every loss within 1e-3 relative, equal
   guided-anchor and PSWarp assignment counts, and the gradients against
   a float64 CPU step: the global norm within 2e-3, each module within
   1e-2 relative L2. Then train_model for 3 epochs of 2 steps with the launch
   counters reset just before and read just after: K1, K3, K3b, K4, K5,
   K5b, K10, K11 and K12 must have launched, every logged loss must be
   finite, no update skipped, and the last checkpoint must restore to the
   trained parameters. K12 is held bitwise against its plain version on
   the first card step's inputs (captured). The train step is timed (host
   clock, synchronised, loader excluded) beside the host leg of a batch
   (voxelize + mask + the C++ train rulebook);
8. three-class training on device plans (multi_config, host_plans=False,
   batch 1): a 4-scan car-range synthetic three-class KITTI train split,
   its info file and GT database written by the port's data.create_data,
   and KittiDataset(train=True) with the GT-sampling augmentor. On an
   augmented sample the device train rulebook (strideT and aux plans
   included) must equal the C++ one bitwise, and one forward_train +
   backward on device plans must agree with the same step on host plans
   on the card (losses 1e-5, gradients 1e-4 per module: only the atomics'
   order differs); a diagnostic line compares K15's
   3-NN sets with a float64 direct-difference 3-NN (no gate). Then
   train_model for 2 epochs of 4 steps with the ring aux and again with
   the exact aux, launch counters reset just before and read just after:
   K6, K7 and K13 must launch in both, K14 in the ring run only, K15 and
   K11's backward in the exact run; every logged loss finite, no update
   skipped. One batch-1 step of each must launch K13 once (the three
   levels' transpose plans in one launch) and K14 once (the three levels'
   aux plans in one launch; ring) or not at all (exact). The steps
   at batch 1 and 2 are timed beside a host-plans step.

9. long range (long_range_config(), grid [40, 1600, 2048], 102,400
   anchors), banded over 4 y-bands (parallel.strategy="banded", the
   user's configs/long_range_banded.py) against replicated on device
   plans, at full width: a 4-scan long-range synthetic KITTI train split
   (frustum scans of about 29,000 voxels: every level of both runs under
   its cap, no band overflow; the voxel count of every level is printed)
   and one denser timing scan (~70,000 voxels). Kernel checks at these
   shapes: K16 (band partition) bitwise, also with a cap that drops
   members; K7 with each band row's y limit bitwise, and replicated on the
   timing scan's level 0 (timed beside torch.unique); K11 with per-row grid
   origins (rows, weights, output bitwise; backward 1e-5). forward_test
   banded vs replicated on two scans at batch 1 (matched detections, boxes
   1e-2, scores 1e-3; launch counts of each run); one forward_train +
   backward at batch 2 banded vs replicated (losses 1e-3; the gradients of
   the objective without the PSWarp loss, which follows the guided
   anchors' top-k, whose near-ties flip between float32 runs: norm 2e-3,
   each module 1e-2; the PSWarp module's full gradients 1e-2; BatchNorm
   running-statistic updates 2e-3; printed beside a replicated step on
   inputs one float32 ulp off); then
   train_model of the banded config for 2 steps at batch 2 (8 band rows):
   K16, K7 and K11 (with a limit, with origins) must launch, every logged
   loss finite, band_overflow 0; one banded train step must launch K13
   and K14 once each. Timed: the timing scan at batch 1, banded
   and replicated in turns, and the train step at batch 2.

10. data-parallel training and evaluation (parallel/dist.py): 2 steps of
   make_train_step on phase 7's config, scans and start weights, global
   batch 2 with the ring aux. 10a: in a one-rank NCCL group against the
   same steps with no group, and the no-group steps once more (a
   determinism control). The group's collectives at world size 1 are
   copies: the losses, the BatchNorm buffers and every coalesced
   reduction must be bitwise equal; the gradient norms and parameters
   bitwise too where the control repeats itself bitwise, and otherwise
   (atomics in the backward) within phase 8's atomics-order tolerances,
   each pair's largest difference printed. K1, K3, K3b, K4, K5, K5b,
   K10, K11 and K12 must launch in the group's run. 10b: two ranks on
   the one card over gloo (NCCL refuses two ranks on one device), each a
   subprocess of this script with a timeout, local batch 1: after 2 steps
   their parameters and buffers must be bitwise equal, and step 1's
   all-reduced losses (1e-3), gradient norm (2e-3) and each module's
   reduced gradients (1e-2 relative L2) must match 10a's single-process
   batch-2 step. 10c: evaluate on the same pair at batch 1 over phase 6's
   4 val scans (raw points served on the card): rank 1 returns (None,
   ""), and the detections rank 0 gathers, deduplicated, must match a
   single-process run_inference's (boxes 1e-2, scores 1e-3). Each rank's
   kernels of its path must launch. Phase 10's wall time and each gate's
   largest difference are printed.

11. the CLIs (sassd_tpu_torch.tools), each process run as
   ``chip_smoke.py --cli-worker`` (the tool's main with its arguments,
   the launch counters reset just before and read just after, every
   train step's metrics and run_inference's annotations recorded), on
   the card by default. 11a: ``tools.train configs/car.py --synthetic
   --epochs 2`` at full width, once uninterrupted and once with
   ``--epochs_per_run 1`` (exit 75, then a relaunch that exits 0): the
   final step, the saved and the final optimizer count, lr and momentum
   equal between the two; every step finite, none skipped; the
   relaunch's first step's losses bitwise equal to a step taken here
   from the same checkpoint on the same batch; the final weights'
   distance from the uninterrupted run printed beside that of a second
   uninterrupted run, the control (not gated: K11's backward atomics);
   K1, K3, K3b, K4, K5, K5b, K10, K11 and K12 launched in each run. 11b:
   ``tools.test`` on the relaunched run's final checkpoint with
   ``--out``: its annotations match an in-process run_inference of the
   same weights as sets (boxes 1e-2, scores 1e-3), its AP text equals
   evaluate's, a result file per scan; K1-K5 launched. 11c:
   ``configs/multi_convergence_r3.py`` (three classes, device plans,
   weight decay on every parameter, the GT database) through a wrapper
   config that changes only its paths and its epochs, on a small corpus
   written by ``tools.make_synth_corpus``: one epoch at batch 1, every
   step finite, every parameter decayed, K6, K7, K13 and K14 among the
   kernels launched. 11d: the PointNet VFE (model.vfe_type="pointnet")
   at car width: forward_test on the card vs the CPU as sets, and one
   train step's losses within 1e-3 of the CPU forward_train's. The CLI
   processes run up to four at a time beside 11d; phase 11's wall
   time and each process's are printed.

Phase 3 holds K1 (rotated overlap) in all four criteria within K1_ATOL
of its plain version and at exactly +0.0 on every pair that its
separation cull rejects, on the 2008-box set and on phase 6's NMS input
(the sorted boxes rotate_nms hands to K1 in one served car scan,
captured), printing the near pairs and a hash of each output, equal
across checkouts exactly when every value is. It holds K2 (NMS keep
flags) bitwise against the plain greedy at
N = 2000 and at 1, 63, 64, 65 and 2113 boxes (the sweep's 64-box blocks
and its register words), at thresholds 0.1 and 0.5. It also holds K8
(device voxelizer) and K9 (anchors mask) against
their plain versions, bitwise, on the car scans (at the 20,000-voxel cap,
so the lowest-key truncation runs; K9 at batch 1, 2 and 5 on the car and
the three-class corner tables) and on one frustum scan, K8 also on a
batch of two with one sample empty and on phase 9's long-range timing
scan (262,144-point cap, 80,000 voxels: the bitmap follows the grid); and the
training kernels at batch 2 on the train plans of the car scans: K10
(sparse-conv weight gradient, also bitwise equal over two calls) and K4's
input gradients at the ladder's 10 training convs, K11 (ring 3-NN
interpolation, forward and backward), K12 (aux targets), K3b (PSWarp
backward, also bitwise equal over two calls, there and on phase 7's first
train step's inputs) and K5b (densify backward); and the kernels of
training on
device plans, at batch 2 on the same scans: K13 (the three levels'
transpose plans, one call; also against the forward stride plans
inverted, its parent design, and again at phase 9's band rows) and K14
(the three levels' aux ring plans, one call) against their plain versions
and the C++ train rulebook, bitwise, and K15 (exact 3-NN) at the full
level sizes (rows, weights and output bitwise, its backward through
K11's).

K5, K5b, K6's level-0 map, K7 (the whole op; with a limit, at the band
rows) and K13 are also timed beside one PyTorch call that computes their
work (library_ms), a yardstick the port never calls; no single call
computes K1's, K2's, K4's, K8's, K9's, K10's or K15's function (each row
says why). K6's other launches of a train step at batch 1 (the maps of
levels 1-3, the subm and stride plans) print torch.profiler's time beside
their bounds. K6's map and its yardstick are also replayed in turns
(map, yardstick, yardstick, map). K8's rows carry the parent design's
torch.sort of the same keys alone (sort_ms). K3 (at 2 x 2048 boxes and
at the serving shape: phase 6's first scan's part map and guided boxes,
batch 1, under inference_mode) and K3b print torch.profiler's kernel
split and their host path taken apart by cProfile (host_split), as
diagnostics; K3b also prints its replay at several tile heights of its
second pass and a replay of torch.zeros of its d_map, K3 a replay of a
one-element fill (the replay's floor), each on its own line. K2, K3,
K3b, K8, K15 and the
yardsticks are also timed as CUDA-graph replays (graph_ms,
library_graph_ms: the device's time without the host's launch path),
except torch.unique,
which reads its output's size back to the host and cannot be captured.
K5b, K12, K13, K14 and the yardsticks are timed over 100 calls each, K5b and
its gather also with the L2 cold before each call (cold_l2_ms). K1 (at
both inputs) and K9 (car batch 1 and 2, and on no voxels: all but its
scatter) are timed by events and graph replay. K11 and
K11' (per level: the forward, the backward with its memset of d_feats,
that memset alone, the zeroing as torch.zeros, and forward + backward
replayed from one graph) and K16 are timed by events and graph replay.
K1, K2, K8, K9, K11, K11' and K16 also print torch.profiler's device
time by kernel
(kernel_split) after their timed runs, as a diagnostic only: those
totals have read below the replay of the same call, so no row carries
them. K12 (batch 2), K13 (its three levels in one call, at batch 2 and
at phase 9's band rows, beside its yardstick read the same way) and K14
(its three levels in one call, at batch 2 and at phase 8's batch-1 shape)
are read four ways, each in their row: events
(ms), replay (graph_ms), torch.profiler's kernel time (profiler_ms, with
kernel_split: the ranking of device time, since a lone replay reads
0.006-0.015 ms even for a one-element fill) and the host clock a call
(host_us, with host_split's parts printed); K14 also prints the
torch.full of its plans' buffer alone, the write part of its time.

Every kernel row carries its bound: the larger of the bytes it must move
(each input read once, each output written once, at this run's active
counts) over the H100's 3.35 TB/s and its operations over the 67 TFLOP/s
of float32 outside the tensor cores.

The second-to-last lines are a JSON object of the kernels and the card's
name and power limit; the last line is the JSON result object.

    python3 chip_smoke.py --kernels-only

runs phases 1-3 and phase 9's kernel checks and prints the kernel rows
under the key kernels_only (without launch counts) and the card, and no
result line: the kernels of two checkouts can be timed in one call, each
from its own root.

    python3 chip_smoke.py --data-parallel-only

builds the kernels and runs phase 10 alone, with no result line.

    python3 chip_smoke.py --cli-only

builds the kernels and runs phase 11 alone, with no result line.
(``--dp-worker`` is the entry of phase 10's rank subprocesses,
``--cli-worker`` that of phase 11's CLI processes.)
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
N_SCANS = 4

# tolerances (see the kernel notes in sassd_tpu_torch/csrc)
K1_ATOL = 1e-4     # m^2 intersection area; float32 with -fmad=false
K3_ATOL = 1e-5     # mean of 28 bilinear samples; only the sum order differs
K4_ATOL = 1e-4     # O(1) outputs, float32 sums of up to 27 * 64 products
K4_RTOL = 1e-4     # in another order than cuBLAS's GEMM
# K5-K9 are held bitwise: a scatter of unique keys, integers, copies of
# points, and float32 sums of integer counts below 2^24
DET_SCORE_ATOL = 1e-3   # card vs CPU detections: cuDNN vs CPU conv sums
DET_BOX_ATOL = 1e-2
# training kernels, relative to the largest magnitude of the plain result:
# K10 and K4's input gradients sum thousands of rows in another order; the
# K11 backward adds with atomics in an order that changes from run to run;
# K3b sums each d_map cell in box order where autograd sums each tap apart
# (and is bitwise equal over two calls). K11's forward, K12 and K5b are
# held bitwise.
TRAIN_GRAD_RTOL = 1e-5
TRAIN_LOSS_RTOL = 1e-3  # card vs CPU train step: cuDNN vs CPU conv sums
# card train-step gradients against a float64 CPU step: the global norm,
# and each module's gradients in relative L2 (float32 rounding, amplified
# by the batch-statistics backward of train-mode BatchNorm)
TRAIN_GNORM_RTOL = 2e-3
TRAIN_GRAD_L2 = 1e-2
# phase 8, device vs host plans on the card: the same cuDNN algorithms on
# bitwise-equal rulebooks leave only the atomics' order (measured on the
# H100: losses equal, grad norms equal to 7 digits, module rel L2 <= 1.1e-6)
PLANS_LOSS_RTOL = 1e-5
PLANS_GNORM_RTOL = 1e-5
PLANS_GRAD_L2 = 1e-4
N_TRAIN_EPOCHS = 3     # of 2 steps at batch 2 over the 4 train scans
N_MULTI_EPOCHS = 2      # phase 8: of 4 steps at batch 1
# phase 9: frustum ground returns of the long-range comparison scans (about
# 29,000 voxels, under every replicated and per-band cap), and the banded
# step's BatchNorm running-statistic updates against the replicated ones,
# relative to each buffer's largest update
LR_GROUND = 60000
BN_UPDATE_RTOL = 2e-3

# phase 10: data-parallel steps; each rank subprocess's time limit and
# the collectives' timeout of every process group the phase makes
DP_STEPS = 2
DP_WORKER_TIMEOUT_S = 300
DP_GROUP_TIMEOUT_S = 120
ADDR_IN_USE = ("address already in use", "eaddrinuse")
# phase 11: the CLIs; each CLI process's time limit, the car runs' epochs
# and the three-class run's corpus (make_synth_corpus) in scans
CLI_TIMEOUT_S = 600
CLI_EPOCHS = 2
CLI_CORPUS = (4, 1)
CLI_CAR = os.path.join(HERE, "configs", "car.py")
CLI_MULTI = os.path.join(HERE, "configs", "multi_convergence_r3.py")

# the sparse ladder's 10 convs (models/backbone.py VxNet) as distinct
# shapes: name, plan, input level, Cin, Cout, convs of that shape
LADDER = (("conv0.0", "plan_subm0", 0, 4, 16, 1),
          ("conv0.1", "plan_subm0", 0, 16, 16, 1),
          ("down0", "plan_stride1", 0, 16, 32, 1),
          ("conv1", "plan_subm1", 1, 32, 32, 2),
          ("down1", "plan_stride2", 1, 32, 64, 1),
          ("conv2", "plan_subm2", 2, 64, 64, 3),
          ("down2", "plan_stride3", 2, 64, 64, 1))

# tile heights of K3b's pass B replayed beside the one in use (at 96
# columns a 5120-float tile holds 53 rows)
K3B_ROWS_TRIED = (8, 16, 25, 50)

# the card's peaks the bounds are taken against (H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# an estimate, printed beside K15's times and kept out of the kernel rows:
# float32 instructions issued one by one at 128 lanes x 132 SMs x 1.98 GHz
# (the clock at which 67 TFLOP/s counts an FMA as two operations)
INSTR_PER_S = 128 * 132 * 1.98e9


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def run(cmd):
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"<{cmd[0]} unavailable: {e}>"


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of fn() on the card (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Mean milliseconds per replay of fn() captured in a CUDA graph: the
    device's time without the host's launch path (Python, ctypes)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters=iters)


def cold_ms(fn, iters: int = 20) -> float:
    """Mean milliseconds of fn() on the card with a cold L2: 256 MB (five
    times the L2) are written before each call, and CUDA events bracket
    fn() alone. The write outlasts fn()'s host path, so the events see
    the device's time."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    total = 0.0
    for _ in range(iters):
        flush.fill_(1.0)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def kernel_split(fn, iters: int = 10, counts: dict = None) -> dict:
    """Device milliseconds per call of each kernel (and memset) that fn()
    runs, by name, from torch.profiler over `iters` calls: the parts of one
    wrapper call. `counts`, where given, receives each name's launches."""
    import re
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            name = re.sub(r"\(anonymous namespace\)::|^void ", "",
                          e.key).split("(")[0][:60]
            out[name] = out.get(name, 0.0) + (e.self_device_time_total
                                              / iters / 1e3)
            if counts is not None:
                counts[name] = counts.get(name, 0) + e.count
    return out


def timed(fn, iters: int = 20) -> dict:
    """fn()'s milliseconds by CUDA events (ms) and replayed from a CUDA
    graph (graph_ms)."""
    return dict(ms=cuda_ms(fn, iters=iters), graph_ms=graph_ms(fn, iters))


def fmt_timed(t: dict) -> str:
    return f"{t['ms']:.4f} ms ({t['graph_ms']:.4f} replayed)"


def fmt_split(fn) -> str:
    """kernel_split(fn) as a diagnostic: torch.profiler's per-kernel totals
    have read below the replay of the same call, so they are printed after
    the timed runs and kept out of the kernel rows."""
    parts = ", ".join(f"{k} {v:.4f}" for k, v in kernel_split(fn).items())
    return f"profiler totals a call (diagnostic, not in the row): {parts}"


# host_split's groups, by the first pattern a cProfile entry (file:function)
# matches: the Python functions and builtins of one wrapper call
HOST_GROUPS = (("check", ("check",)),
               ("device context", ("torch/cuda/__init__.py",)),
               ("allocation", ("torch.empty", "torch.zeros", "new_empty")),
               ("autograd", ("autograd/function.py", "method apply",
                             "_functorch", "save_for_backward")),
               ("launch (ctypes)", ("cuda.py:launch", "RawStream",
                                    "_cuda_getDevice")))


def host_split(fn, iters: int = 200):
    """The host path of one call of fn(): the host clock per call over
    `iters` calls (us), and as a diagnostic (text) cProfile's self time per
    call (each Python function and builtin; the profiler's own cost
    inflates each), summed by HOST_GROUPS, and its largest entries. The
    ctypes call runs inside cuda.py's Kernel.launch and counts there."""
    import cProfile
    import pstats
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    wall_us = (time.perf_counter() - t) * 1e6 / iters
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(iters):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    keys = [(f"{path}:{name}", tottime * 1e6 / iters) for (path, _, name), (
        _, _, tottime, _, _) in pstats.Stats(prof).stats.items()
        if "chip_smoke.py" not in path]
    groups = {g: 0.0 for g, _ in HOST_GROUPS}
    groups["other"] = 0.0
    for key, us in keys:
        g = next((g for g, pats in HOST_GROUPS
                  if any(p in key for p in pats)), "other")
        groups[g] += us
    top = sorted(keys, key=lambda kv: -kv[1])[:8]
    return wall_us, (
        f"host path a call (diagnostic): {wall_us:.1f} us by the host "
        f"clock; cProfile self us a call: "
        + ", ".join(f"{g} {us:.1f}" for g, us in groups.items())
        + "; largest: "
        + ", ".join(f"{k.split('/')[-1][:48]} {us:.1f}" for k, us in top))


def measured(fn, what: str, iters: int = 20) -> dict:
    """fn() by CUDA events (ms), replayed from a CUDA graph (graph_ms), by
    torch.profiler's kernel time a call (profiler_ms, the sum of
    kernel_split) and by the host clock a call (host_us), each printed:
    the four readings of a small kernel whose event time is mostly its
    host path. Rank device time by profiler_ms (a lone replay reads
    0.006-0.015 ms even for a one-element fill), the host path by ms and
    host_us."""
    t = timed(fn, iters)
    for _ in range(3):      # the profiler can drop some calls' kernels
        counts = {}
        split = kernel_split(fn, counts=counts)
        if split and min(counts.values()) >= 10:
            break
    host_us, host_text = host_split(fn)
    print(f"  {what}: kernel {fmt_timed(t)}; profiler "
          + (", ".join(f"{k} {v:.4f}" for k, v in split.items())
             or "saw no kernel (not measured)")
          + f" ms a call; {host_text}")
    return dict(**t, profiler_ms=sum(split.values()) if split else None,
                kernel_split=split, host_us=host_us)


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take for the work: bytes over the
    memory rate or operations over the float32 rate, whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=float(nbytes), bound_ops=float(ops))


def add_bounds(rows) -> dict:
    """Sum of the bounds of several calls timed as one row."""
    nbytes = sum(r["bound_bytes"] for r in rows)
    ops = sum(r["bound_ops"] for r in rows)
    out = bound(nbytes, ops)
    out["bound_ms"] = sum(r["bound_ms"] for r in rows)
    return out


def rel_err(got, ref) -> float:
    """max |got - ref| over max |ref|."""
    ref = ref.detach().double()
    return float((got.detach().double() - ref).abs().max()
                 / ref.abs().max().clamp(min=1e-30))


def grad_ms(out, inputs, cot, iters: int = 20) -> float:
    """Milliseconds of one autograd backward of `out` (graph retained)."""
    import torch
    return cuda_ms(lambda: torch.autograd.grad(out, inputs, cot,
                                               retain_graph=True),
                   iters=iters)


def keys_bzyx(torch, keys, shape_zyx):
    """The (b, z, y, x) index tensors of the active rows of [B, M] keys."""
    from sassd_tpu_torch.ops import sparse as sp
    ok = keys != sp.INVALID_KEY
    b = torch.nonzero(ok)[:, 0]
    k = keys[ok].long()
    _, h, w = shape_zyx
    return b, k // (h * w), (k // w) % h, k % w


def reset_launches():
    from sassd_tpu_torch.ops import cuda
    for kern in cuda.KERNELS.values():
        kern.launches = 0


def read_launches() -> dict:
    from sassd_tpu_torch.ops import cuda
    return {k: v.launches for k, v in cuda.KERNELS.items()}


def train_step_ms(torch, step, model, batch, n: int = 3):
    """Host-clock ms of n synchronised train steps after one warm-up."""
    step(model, batch)
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        t = time.perf_counter()
        step(model, batch)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return out


def nms_boxes(rng, n: int):
    """NMS-like candidates: clusters of jittered car boxes over the KITTI
    range, so that many pairs overlap."""
    import numpy as np
    n_obj = max(n // 20, 1)
    centers = np.stack([rng.uniform(0, 70.4, n_obj),
                        rng.uniform(-40, 40, n_obj)], 1)
    which = rng.integers(0, n_obj, n)
    b = np.zeros((n, 5), np.float32)
    b[:, :2] = centers[which] + rng.normal(0, 0.6, (n, 2))
    b[:, 2] = rng.uniform(1.4, 1.9, n)
    b[:, 3] = rng.uniform(3.2, 4.6, n)
    b[:, 4] = rng.uniform(-np.pi, np.pi, n)
    return b


DEGENERATE = [
    [0.0, 0.0, 2.0, 4.0, 0.0], [0.0, 0.0, 2.0, 4.0, 0.0],
    [2.0, 0.0, 2.0, 4.0, 0.0], [0.0, 0.0, 1.0, 2.0, 0.0],
    [10.0, 10.0, 2.0, 4.0, 0.0], [0.5, 0.0, 2.0, 4.0, 0.0],
    [0.0, 0.0, 2.0, 4.0, 1.5707963], [0.0, 0.0, 2.0, 4.0, 3.1415927],
]


# criterion-2 areas of pairs of DEGENERATE, appended last to a box set
DEGENERATE_AREAS = {(0, 1): 8.0, (0, 2): 0.0, (0, 3): 2.0, (0, 4): 0.0,
                    (0, 6): 4.0, (0, 7): 8.0}


def k1_check(torch, riou_kernel, boxes, what: str,
             degenerate: bool = False) -> dict:
    """K1 on [N, 5] card boxes against itself in all four criteria: within
    K1_ATOL of the plain version, and exactly +0.0 on every pair that the
    separation cull rejects; with `degenerate`, the last boxes are
    DEGENERATE and their criterion-2 areas must be DEGENERATE_AREAS.
    Returns the largest error, the near-pair count and a hash of each
    criterion's bytes (equal across checkouts exactly when every value is
    bitwise equal)."""
    import hashlib
    near = riou_kernel.near_pairs_plain(boxes, boxes)
    err, sums, bad, deg = 0.0, {}, {}, {}
    for crit in (2, -1, 0, 1):
        got = riou_kernel.rotate_overlap(boxes, boxes, crit)
        ref = riou_kernel.rotate_overlap_plain(boxes, boxes, crit)
        err = max(err, float((got - ref).abs().max()))
        sums[crit] = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest(
            )[:16]
        bad[crit] = int((got.view(torch.int32)[~near] != 0).sum())
        if crit == 2 and degenerate:
            k = len(DEGENERATE)
            tail = got[-k:, -k:].cpu().numpy()
            deg = {ij: float(tail[ij]) for ij, v in DEGENERATE_AREAS.items()
                   if abs(tail[ij] - v) > 1e-2}
    n = boxes.shape[0]
    n_near = int(near.sum())
    # near pairs per 64 x 64 tile of the kernel's grid: a block clips its
    # own tile's near pairs
    nt = -(-n // K1_TILE)
    grid = torch.zeros((nt * K1_TILE, nt * K1_TILE), dtype=torch.int32,
                       device=near.device)
    grid[:n, :n] = near.int()
    per = grid.view(nt, K1_TILE, nt, K1_TILE).sum((1, 3)).flatten()
    dense = per > K1_TILE * K1_TILE // 4
    deg_note = f"degenerate pairs {deg or 'ok'}; " if degenerate else ""
    print(f"K1 on {what}, N = {n}, criteria 2, -1, 0, 1: max|kernel-plain| "
          f"{err:.3g} (tol {K1_ATOL}); near pairs {n_near} "
          f"({n_near / n / n:.4%}) (per {K1_TILE}x{K1_TILE} tile: mean "
          f"{float(per.float().mean()):.1f}, max {int(per.max())}; "
          f"{int(dense.sum())} of {per.numel()} tiles over a quarter near "
          f"hold {float(per[dense].sum() / per.sum().clamp(min=1)):.1%} of "
          f"them); culled pairs not +0.0: {bad}; {deg_note}output hashes "
          f"{sums}")
    if not err <= K1_ATOL or any(bad.values()) or deg:
        fail(f"K1 disagrees with its plain version on {what}")
    return dict(max_abs_err=err, n_near=n_near, checksums=sums)


# a near pair's full clipping: corners, 2 x 4 clipped edges; a pair's cull
# test: two differences, two squares, a sum, two adds, a square, a compare
K1_PAIR_OPS = 400
K1_CULL_OPS = 9
K1_TILE = 64            # boxes a side of a block's tile (riou_overlap.cu)


def k1_bound(n: int, m: int, n_near: int) -> dict:
    """K1's bound on [N, 5] x [M, 5] boxes: the boxes in, the matrix out;
    the cull test for every pair and the full clipping for the n_near
    pairs it keeps."""
    return bound((n + m) * 5 * 4 + n * m * 4,
                 n * m * K1_CULL_OPS + n_near * K1_PAIR_OPS)


def serving_split(torch, np, device, cfg, root: str):
    """Phase 6's inputs: a 4-scan synthetic KITTI val split written under
    root, its dataset, the serving step on `device` and the collated
    batches of one and of two scans."""
    import dataclasses
    from sassd_tpu_torch import serve
    from sassd_tpu_torch.data import kitti, synthetic
    cfg_pts = dataclasses.replace(cfg, test=dataclasses.replace(
        cfg.test, device_input="points"))
    synthetic.write_synthetic_kitti(root, n_train=0, n_val=N_SCANS,
                                    seed=SEED)
    ds = kitti.KittiDataset(cfg, os.path.join(root, "training"),
                            os.path.join(root, "ImageSets", "val.txt"))
    view = serve.PointsView(ds, cfg_pts)
    step = serve.make_serving_step(cfg_pts, ds.anchors, ds.anchors_bv,
                                   device)
    batch1 = [kitti.collate([view[i]])[0] for i in range(N_SCANS)]
    batch2 = [kitti.collate([view[i], view[i + 1]])[0]
              for i in range(0, N_SCANS, 2)]
    return cfg_pts, ds, step, batch1, batch2


def serving_inputs(torch, np, device, cfg, model_dev):
    """The inputs of K1 and K3 in phase 6's first served car scan, captured
    in one serving step: the sorted boxes that rotate_nms hands to K1, and
    pswarp_score's part map, guided boxes, validity and arguments."""
    from sassd_tpu_torch.core import riou
    from sassd_tpu_torch.ops import warp
    seen, k3 = [], []
    orig, orig_k3 = riou.rotate_iou_bev, warp.pswarp_score

    def capture(a, b):
        seen.append(a.clone())
        return orig(a, b)

    def capture_k3(part_map, boxes, valid, *args):
        k3.append((part_map.clone(), boxes.clone(), valid.clone(), args))
        return orig_k3(part_map, boxes, valid, *args)
    with tempfile.TemporaryDirectory() as root:
        _, _, step, batch1, _ = serving_split(torch, np, device, cfg, root)
        riou.rotate_iou_bev, warp.pswarp_score = capture, capture_k3
        try:
            step(model_dev, batch1[0])
        finally:
            riou.rotate_iou_bev, warp.pswarp_score = orig, orig_k3
    torch.cuda.synchronize()
    return seen[0], k3[0]


def check_k3_serving(torch, k3_inputs) -> dict:
    """K3 at the serving shape: phase 6's first scan's part map and guided
    boxes (batch 1), under inference_mode as the serving step runs it (the
    mode entered once, as the step enters it)."""
    from sassd_tpu_torch.ops import warp
    part_map, boxes3, valid, args = k3_inputs
    b, k, h, w = part_map.shape
    n = boxes3.shape[1]

    def call():
        return warp.pswarp_score(part_map, boxes3, valid, *args)
    with torch.inference_mode():
        got = call()
        ref = warp.pswarp_score_plain(part_map, boxes3, valid, *args)
        err = float((got - ref).abs().max())
        n_valid = int(valid.sum())
        print(f"K3 pswarp_score at the serving shape {tuple(part_map.shape)} "
              f"x {n} boxes ({n_valid} valid): max|kernel-plain| = {err:.3g} "
              f"(tol {K3_ATOL})")
        if not err <= K3_ATOL:
            fail("K3 disagrees with its plain version at the serving shape")
        t = timed(call)
        plain_ms = cuda_ms(
            lambda: warp.pswarp_score_plain(part_map, boxes3, valid, *args),
            iters=5)
        print(f"  K3 serving b1: kernel {fmt_timed(t)}, plain "
              f"{plain_ms:.4f} ms; {fmt_split(call)}")
        print(f"  K3 serving b1 {host_split(call)[1]}")
    return dict(name="K3 pswarp_score, serving b1", route="cuda",
                source="sassd_tpu_torch/csrc/pswarp_score.cu",
                replaces="sassd_tpu/ops/warp.py:76", max_abs_err=err, **t,
                plain_ms=plain_ms, library_ms=None,
                library_what="none, as K3", n_valid=n_valid,
                at=f"phase 6's first scan, batch 1 x {n} guided boxes",
                **k3_bound(b, n, k))


def k3_bound(b: int, n: int, k: int) -> dict:
    """K3's bound: boxes, valid and scores, 4 map taps a part; ~70
    operations a part (lattice, sin/cos, 4 weights)."""
    return bound(b * n * (7 * 4 + 1 + 4) + b * n * k * 4 * 4, b * n * k * 70)


def check_nms_input(torch, riou_kernel, boxes) -> dict:
    """K1 at the NMS input of phase 6's first served car scan (criterion
    -1), checked as on the 2008-box set and timed."""
    k1 = k1_check(torch, riou_kernel, boxes, "phase 6's NMS input")
    t = timed(lambda: riou_kernel.rotate_overlap(boxes, boxes, -1))
    n = boxes.shape[0]
    print(f"  K1 at phase 6's NMS input, N = {n}, criterion -1: kernel "
          f"{fmt_timed(t)}; bound "
          f"{k1_bound(n, n, k1['n_near'])['bound_ms']:.4f} ms")
    return dict(nms_n=n, nms_n_near=k1["n_near"], nms_ms=t["ms"],
                nms_graph_ms=t["graph_ms"],
                nms_bound_ms=k1_bound(n, n, k1["n_near"])["bound_ms"],
                nms_checksums=k1["checksums"],
                max_abs_err=k1["max_abs_err"])


def check_kernels(torch, np, device):
    """Phase 3: each kernel against its plain version at path shapes."""
    from sassd_tpu_torch.core import riou
    from sassd_tpu_torch.ops import riou_kernel, warp

    rng = np.random.default_rng(SEED)
    rows = []
    # K1: 2000 x 2000 candidates + the degenerate set, raw areas
    boxes = np.concatenate([nms_boxes(rng, 2000),
                            np.asarray(DEGENERATE, np.float32)])
    bt = torch.from_numpy(boxes).to(device)
    k1 = k1_check(torch, riou_kernel, bt, "the 2008-box set",
                  degenerate=True)
    t1 = timed(lambda: riou_kernel.rotate_overlap(bt, bt, 2))
    plain_ms = cuda_ms(lambda: riou_kernel.rotate_overlap_plain(bt, bt, 2),
                       iters=5)
    print(f"  K1 {bt.shape[0]}^2, criterion 2: kernel {fmt_timed(t1)}, plain "
          f"{plain_ms:.4f} ms; "
          f"{fmt_split(lambda: riou_kernel.rotate_overlap(bt, bt, 2))}")
    rows.append(dict(name="K1 rotate_overlap", route="cuda",
                     source="sassd_tpu_torch/csrc/riou_overlap.cu",
                     replaces="sassd_tpu/ops/pallas/riou_kernel.py:137",
                     max_abs_err=k1["max_abs_err"], **t1,
                     plain_ms=plain_ms, library_ms=None,
                     library_what="none: torch has no rotated-box overlap",
                     at=f"{bt.shape[0]}^2 boxes, criterion 2",
                     n_near=k1["n_near"], checksums=k1["checksums"],
                     **k1_bound(bt.shape[0], bt.shape[0], k1["n_near"])))

    # K2: keep flags on the same boxes with random scores, then at sizes
    # around the sweep's 64-box blocks and its register words
    scores = torch.from_numpy(rng.uniform(0, 1, 2000).astype(np.float32))
    order = torch.argsort(-scores, stable=True).to(device)
    srt = bt[:2000][order].contiguous()
    iou = riou.rotate_iou_bev(srt, srt)
    keep0 = torch.from_numpy(rng.uniform(size=2000) < 0.95).to(device)
    rng2 = np.random.default_rng(SEED + 20)
    cases = [(iou, keep0)]
    for n2 in (1, 63, 64, 65, 2113):
        b2 = torch.from_numpy(nms_boxes(rng2, n2)).to(device)
        cases.append((riou.rotate_iou_bev(b2, b2), torch.from_numpy(
            rng2.uniform(size=n2) < 0.95).to(device)))
    err2 = 0
    for iou_c, keep0_c in cases:
        for thr in (0.1, 0.5):
            k_got = riou.nms_keep(iou_c, keep0_c, thr)
            k_ref = riou.nms_keep_plain(iou_c, keep0_c, thr)
            n_diff = int((k_got != k_ref).sum())
            err2 = max(err2, n_diff)
            print(f"K2 nms_keep N={keep0_c.shape[0]} thr={thr}: kept "
                  f"{int(k_got.sum())}, flags differing from plain greedy: "
                  f"{n_diff}")
    if err2:
        fail("K2 keep flags differ from the plain greedy")
    # the NMS path's threshold 0.1, and 0.5, where a 64-box block keeps
    # more boxes (K2's sweep follows the kept boxes)
    ms = cuda_ms(lambda: riou.nms_keep(iou, keep0, 0.1))
    dev_ms = graph_ms(lambda: riou.nms_keep(iou, keep0, 0.1))
    ms5 = cuda_ms(lambda: riou.nms_keep(iou, keep0, 0.5))
    dev_ms5 = graph_ms(lambda: riou.nms_keep(iou, keep0, 0.5))
    plain_ms = cuda_ms(lambda: riou.nms_keep_plain(iou, keep0, 0.1), iters=5)
    print(f"  K2 N=2000: kernel {ms:.4f} ms ({dev_ms:.4f} replayed from a "
          f"CUDA graph), plain {plain_ms:.4f} ms; at thr 0.5 {ms5:.4f} ms "
          f"({dev_ms5:.4f} replayed); "
          f"{fmt_split(lambda: riou.nms_keep(iou, keep0, 0.1))}")
    rows.append(dict(name="K2 nms_keep", route="cuda",
                     source="sassd_tpu_torch/csrc/rotate_nms.cu",
                     replaces="sassd_tpu/core/riou.py:188",
                     max_abs_err=float(err2), ms=ms, graph_ms=dev_ms,
                     thr05_ms=ms5, thr05_graph_ms=dev_ms5,
                     plain_ms=plain_ms, library_ms=None,
                     library_what="none: torch has no rotated NMS and no "
                                  "greedy keep over an IoU matrix",
                     at="N = 2000, thr 0.1",
                     # the upper triangle of the matrix and keep0 in, the
                     # flags out; a compare a pair
                     **bound(2000 * 1999 // 2 * 4 + 2 * 2000,
                             2000 * 1999 // 2)))

    # K3: [2, 28, 200, 176] part map, 2048 boxes per sample, ~10% off-map
    b, k, h, w, n = 2, 28, 200, 176, 2048
    part_map = torch.from_numpy(
        rng.normal(size=(b, k, h, w)).astype(np.float32)).to(device)
    bx = np.zeros((b, n, 7), np.float32)
    bx[..., 0] = rng.uniform(0, 70.4, (b, n))
    bx[..., 1] = rng.uniform(-40, 40, (b, n))
    off = rng.uniform(size=(b, n)) < 0.1
    bx[..., 0][off] = rng.choice([-1.5, 71.5], off.sum())
    bx[..., 2] = -1.0
    bx[..., 3:6] = [1.6, 3.9, 1.56]
    bx[..., 6] = rng.uniform(-np.pi, np.pi, (b, n))
    boxes3 = torch.from_numpy(bx).to(device)
    valid = torch.from_numpy(rng.uniform(size=(b, n)) < 0.9).to(device)
    args = ((4, 7), (0.0, 40.0), 1.0 / 0.4)
    got = warp.pswarp_score(part_map, boxes3, valid, *args)
    ref = warp.pswarp_score_plain(part_map, boxes3, valid, *args)
    err3 = float((got - ref).abs().max())
    print(f"K3 pswarp_score {tuple(part_map.shape)} x {n} boxes: "
          f"max|kernel-plain| = {err3:.3g} (tol {K3_ATOL})")
    if not err3 <= K3_ATOL:
        fail("K3 disagrees with its plain version")

    def k3():
        return warp.pswarp_score(part_map, boxes3, valid, *args)
    t3 = timed(k3)
    plain_ms = cuda_ms(
        lambda: warp.pswarp_score_plain(part_map, boxes3, valid, *args),
        iters=5)
    print(f"  K3 batch 2: kernel {fmt_timed(t3)}, plain {plain_ms:.4f} ms; "
          f"{fmt_split(k3)}")
    print(f"  K3 batch 2 {host_split(k3)[1]}")
    one = torch.zeros(1, device=device)
    print(f"  lone replay, not a kernel row: a one-element zero_ (the "
          f"replay harness's floor) {graph_ms(one.zero_):.4f} ms")
    rows.append(dict(name="K3 pswarp_score", route="cuda",
                     source="sassd_tpu_torch/csrc/pswarp_score.cu",
                     replaces="sassd_tpu/ops/warp.py:76",
                     max_abs_err=err3, **t3, plain_ms=plain_ms,
                     library_ms=None,
                     library_what="none: grid_sample samples every channel "
                                  "at every point; the part's channel and "
                                  "the mean take more calls",
                     at=f"batch 2 x {n} boxes", **k3_bound(b, n, k)))
    return rows


def check_sparse_kernels(torch, np, device, cfg, samples):
    """Phase 3, K4-K7, on the host plans of the car-config scans."""
    from sassd_tpu_torch.ops import sparse as sp

    rng = np.random.default_rng(SEED + 1)
    s0 = {k: torch.from_numpy(v[None]).to(device) for k, v in samples[0].items()}
    caps = (cfg.voxel.max_voxels,) + tuple(cfg.caps.level_caps[1:])
    shapes = [cfg.sparse_shape]
    for _ in range(3):
        shapes.append(sp.out_shape_stride2(shapes[-1]))
    rows = []

    # K4 at the ladder's 10 convs (7 distinct shapes), on the int16 wire
    # plans of scan 0 (batch 1)
    k4 = []
    for name, plan_key, level_in, cin, cout, mult in LADDER:
        feats = torch.from_numpy(rng.normal(
            size=(1, caps[level_in], cin)).astype(np.float32)).to(device)
        w = torch.from_numpy((rng.normal(size=(27, cin, cout))
                              / np.sqrt(27 * cin)).astype(np.float32)
                             ).to(device)
        plan = s0[plan_key]
        got = sp.subm_conv_batched(feats, w, plan)
        ref = sp.subm_conv_batched_plain(feats, w, plan)
        err = float((got - ref).abs().max())
        ok = bool(torch.allclose(got, ref, rtol=K4_RTOL, atol=K4_ATOL))
        ms = cuda_ms(lambda: sp.subm_conv_batched(feats, w, plan))
        plain_ms = cuda_ms(lambda: sp.subm_conv_batched_plain(feats, w, plan))
        found = int((plan >= 0).sum())
        bd = bound(feats.numel() * 4 + plan.numel() * plan.element_size()
                   + w.numel() * 4 + plan.shape[2] * cout * 4,
                   2 * found * cin * cout)
        print(f"K4 sparse_conv {name} x{mult} {plan_key[5:]} "
              f"{tuple(plan.shape)} {cin}->{cout}: found slots "
              f"{found / plan.numel():.4f}; max|kernel-plain| = {err:.3g} "
              f"(rtol {K4_RTOL}, atol {K4_ATOL}); kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms "
              f"({bd['bound_by']})")
        if not ok:
            fail(f"K4 disagrees with its plain version on {name}")
        k4.append((name, mult, err, ms, plain_ms, found / plan.numel(), bd))
    rows.append(dict(name="K4 sparse_conv", route="cuda",
                     source="sassd_tpu_torch/csrc/sparse_conv.cu",
                     replaces="sassd_tpu/ops/sparse.py:411",
                     max_abs_err=max(e for _, _, e, *_ in k4),
                     ms=sum(n * m for _, n, _, m, *_ in k4),
                     plain_ms=sum(n * m for _, n, _, _, m, *_ in k4),
                     library_ms=None,
                     library_what="none: the 27 taps' row gather and the "
                                  "product are separate calls (conv3d is "
                                  "dense, not the submanifold function)",
                     at="batch 1, one scan's forward: the ladder's 10 convs,"
                        " launches x ms summed",
                     per_shape={name: dict(convs=n, ms=m, plain_ms=pm,
                                           found_frac=ff, **bd)
                                for name, n, _, m, pm, ff, bd in k4},
                     **add_bounds([bd for _, n, *_, bd in k4
                                   for _ in range(n)])))

    # K5: scan 0's level 3 (10240 rows x 64) into [1, 5*64, 200, 176]
    keys3 = sp.coords_to_keys(s0["plan_coords3"], shapes[3])
    x3 = torch.from_numpy(rng.normal(size=(1, caps[3], 64)).astype(
        np.float32)).to(device) * (keys3 != sp.INVALID_KEY)[..., None]
    canvas, occ = sp.densify_nchw(keys3, x3, shapes[3])
    ref_canvas, ref_occ = sp.densify_nchw_plain(keys3, x3, shapes[3])
    same5 = torch.equal(canvas, ref_canvas) and torch.equal(occ, ref_occ)
    err5 = float(max((canvas - ref_canvas).abs().max(),
                     (occ - ref_occ).abs().max()))
    ms = cuda_ms(lambda: sp.densify_nchw(keys3, x3, shapes[3]))
    dev5_ms = graph_ms(lambda: sp.densify_nchw(keys3, x3, shapes[3]))
    plain_ms = cuda_ms(lambda: sp.densify_nchw_plain(keys3, x3, shapes[3]))
    print(f"K5 densify {tuple(x3.shape)} -> {tuple(canvas.shape)}: "
          f"{'bitwise equal to' if same5 else 'DIFFERS from'} plain; "
          f"kernel {ms:.4f} ms ({dev5_ms:.4f} replayed from a CUDA graph), "
          f"plain {plain_ms:.4f} ms")
    if not same5:
        fail("K5 differs from its plain version")
    d3, h3, w3 = shapes[3]
    # the one-call yardstick: index_put_ of the active rows into a zeroed
    # [B, D, C, H, W] canvas (K5's canvas; its occupancy aside)
    bzyx = keys_bzyx(torch, keys3, shapes[3])
    rows3 = x3[keys3 != sp.INVALID_KEY]

    def put5():
        canvas = torch.zeros((1, d3, 64, h3, w3), device=device)
        canvas[bzyx[0], bzyx[1], :, bzyx[2], bzyx[3]] = rows3
    lib_ms = cuda_ms(put5)
    lib_graph_ms = graph_ms(put5)
    print(f"  K5 one-call yardstick (zeros + index_put_): {lib_ms:.4f} ms "
          f"({lib_graph_ms:.4f} replayed from a CUDA graph)")
    rows.append(dict(name="K5 densify", route="cuda",
                     source="sassd_tpu_torch/csrc/densify.cu",
                     replaces="sassd_tpu/ops/sparse.py:835",
                     max_abs_err=err5, ms=ms, graph_ms=dev5_ms,
                     plain_ms=plain_ms, library_ms=lib_ms,
                     library_graph_ms=lib_graph_ms,
                     library_what="torch.zeros + index_put_ of the rows "
                                  "into the NCHW canvas (no occupancy)",
                     # keys and rows in; the zeroed canvas and occupancy out
                     **bound(x3.numel() * 4 + keys3.numel() * 4
                             + canvas.numel() * 4 + occ.numel() * 4, 0)))

    # K6 + K7: the device rulebook of all scans as one batch, level by
    # level against the plain versions on the same inputs, then the whole
    # rulebook against the C++ host rulebook
    coords0 = torch.from_numpy(np.stack([s["coords"] for s in samples]))
    keys = sp.coords_to_keys(coords0.to(device), shapes[0])
    err6 = err7 = 0.0
    dev_plans = {}
    for lvl in range(4):
        if lvl > 0:
            out = sp.downsample_keys(keys, shapes[lvl - 1], caps[lvl])
            ref = sp.downsample_keys_plain(keys, shapes[lvl - 1], caps[lvl])
            err7 = max(err7, float((out - ref).abs().max()))
            plan = sp.window_plan(out, shapes[lvl], imap, shapes[lvl - 1], 2)
            ref = sp.window_plan_plain(out, shapes[lvl], imap,
                                       shapes[lvl - 1], 2)
            err6 = max(err6, float((plan - ref).abs().max()))
            dev_plans[f"stride{lvl}"] = plan
            dev_plans[f"coords{lvl}"] = sp.keys_to_coords(out, shapes[lvl])
            keys = out
        if lvl < 3:
            imap = sp.build_index_map(keys, shapes[lvl])
            ref = sp.build_index_map_plain(keys, shapes[lvl])
            err6 = max(err6, float((imap - ref).abs().max()))
            plan = sp.window_plan(keys, shapes[lvl], imap, shapes[lvl], 1)
            ref = sp.window_plan_plain(keys, shapes[lvl], imap, shapes[lvl],
                                       1)
            err6 = max(err6, float((plan - ref).abs().max()))
            dev_plans[f"subm{lvl}"] = plan
    del imap, ref
    host_diff = {}
    for k, v in dev_plans.items():
        host = np.stack([s[f"plan_{k}"] for s in samples]).astype(np.int32)
        n = int((v.cpu().numpy() != host).sum())
        if n:
            host_diff[k] = n
    print(f"K6 index maps + window plans, K7 downsample, {len(samples)} "
          f"scans: max|kernel-plain| K6 {err6:g}, K7 {err7:g}; entries "
          f"differing from the C++ host rulebook (subm0-2, stride1-3, "
          f"coords1-3): {host_diff or 'none'}")
    if err6 or err7 or host_diff:
        fail("the device rulebook differs from its plain version or the "
             "host rulebook")

    keys0 = sp.coords_to_keys(s0["coords"], shapes[0])

    def k6(fn_map, fn_plan):
        imap = fn_map(keys0, shapes[0])
        return fn_plan(keys0, shapes[0], imap, shapes[0], 1)
    ms = cuda_ms(lambda: k6(sp.build_index_map, sp.window_plan))
    plain_ms = cuda_ms(lambda: k6(sp.build_index_map_plain,
                                  sp.window_plan_plain))
    m0 = keys0.shape[1]
    total0 = shapes[0][0] * shapes[0][1] * shapes[0][2]
    # the map alone beside one torch.full + index_put_ of the valid rows
    map_ms = cuda_ms(lambda: sp.build_index_map(keys0, shapes[0]))
    ok0 = keys0[0] != sp.INVALID_KEY
    key_idx = keys0[0][ok0].long()
    row_vals = torch.nonzero(ok0)[:, 0].to(torch.int32)

    def put6():
        imap = torch.full((total0,), -1, dtype=torch.int32, device=device)
        imap.index_put_((key_idx,), row_vals)
    lib6_ms = cuda_ms(put6)
    map_graph_ms = graph_ms(lambda: sp.build_index_map(keys0, shapes[0]))
    lib6_graph_ms = graph_ms(put6)
    print(f"  K6 L0 map + subm0 plan (batch 1): kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms; the map alone {map_ms:.4f} ms "
          f"({map_graph_ms:.4f} replayed from a CUDA graph), one-call "
          f"yardstick (full + index_put_) {lib6_ms:.4f} ms "
          f"({lib6_graph_ms:.4f} replayed)")
    # the map's two replay modes: the map and its yardstick in turns (map,
    # yardstick, yardstick, map), each turn three graphs of 50 replays
    turns = []
    for what, fn in (("map", lambda: sp.build_index_map(keys0, shapes[0])),
                     ("yardstick", put6), ("yardstick", put6),
                     ("map", lambda: sp.build_index_map(keys0, shapes[0]))):
        turns.append((what, [graph_ms(fn, iters=50) for _ in range(3)]))
    print("  K6 L0 map against its yardstick in turns, replayed: "
          + "; ".join(f"{w} {', '.join(f'{t:.4f}' for t in ts)}"
                      for w, ts in turns))
    # K6's other launches of a train step at batch 1 (the maps of levels
    # 1-3, the subm and stride plans), each by torch.profiler's device time
    # a call (its map's memset included) beside its bound: keys in, a map
    # written whole, a plan written whole with 27 map reads a valid row
    lk = [keys0]
    for lvl in (1, 2, 3):
        lk.append(sp.downsample_keys(lk[-1], shapes[lvl - 1], caps[lvl]))
    lmaps = [sp.build_index_map(k, sh) for k, sh in zip(lk, shapes)]
    parts = {}
    for lvl in range(4):
        m = lk[lvl].shape[1]
        n = int((lk[lvl] != sp.INVALID_KEY).sum())
        plan_bd = bound(m * 4 + 27 * m * 4 + 27 * n * 4, 0)
        if lvl:
            total = shapes[lvl][0] * shapes[lvl][1] * shapes[lvl][2]
            parts[f"L{lvl} map"] = (
                lambda lvl=lvl: sp.build_index_map(lk[lvl], shapes[lvl]),
                bound(m * 4 + total * 4, 0))
            parts[f"stride{lvl} plan"] = (
                lambda lvl=lvl: sp.window_plan(lk[lvl], shapes[lvl],
                                               lmaps[lvl - 1],
                                               shapes[lvl - 1], 2), plan_bd)
        if lvl < 3:
            parts[f"subm{lvl} plan"] = (
                lambda lvl=lvl: sp.window_plan(lk[lvl], shapes[lvl],
                                               lmaps[lvl], shapes[lvl], 1),
                plan_bd)
    k6_parts = {}
    for what, (fn, bd) in parts.items():
        split = kernel_split(fn)
        prof = sum(split.values()) if split else None
        k6_parts[what] = dict(profiler_ms=prof, kernel_split=split,
                              bound_ms=bd["bound_ms"],
                              bound_bytes=bd["bound_bytes"])
    del lmaps
    print("  K6's other launches, batch 1 (profiler ms a call / bound ms): "
          + "; ".join(f"{w} " + ("not measured" if v["profiler_ms"] is None
                                 else f"{v['profiler_ms']:.4f}")
                      + f" / {v['bound_ms']:.4f}"
                      for w, v in k6_parts.items()))
    rows.append(dict(name="K6 device_plans", route="cuda",
                     source="sassd_tpu_torch/csrc/device_plans.cu",
                     replaces="sassd_tpu/ops/sparse.py:84",
                     max_abs_err=err6, ms=ms, plain_ms=plain_ms,
                     map_ms=map_ms, map_graph_ms=map_graph_ms,
                     map_turns_graph_ms=turns, other_launches=k6_parts,
                     library_ms=lib6_ms, library_graph_ms=lib6_graph_ms,
                     library_what="torch.full(-1) + index_put_ of the valid "
                                  "rows: the L0 map alone, against map_ms",
                     at="L0 index map + subm0 plan, batch 1",
                     # keys in, the whole map written, 27 map reads and
                     # one plan entry out per row and tap
                     **bound(m0 * 4 + total0 * 4 + 2 * 27 * m0 * 4, 0)))
    rows.append(k7_row(torch, sp, keys0, shapes[0], caps[1], err7,
                       "K7 downsample", "L0 -> L1, batch 1, the car scan"))
    return rows


def k7_row(torch, sp, keys, shape, cap, err, name, at, y_limit=None):
    """K7's kernel row: the whole op (K7 on the card) against its plain
    version and, on one row, torch.unique of its candidates (one call,
    sorted: the same set before the cap), on [B, M] keys."""
    ms = cuda_ms(lambda: sp.downsample_keys(keys, shape, cap, y_limit))
    dev_ms = graph_ms(lambda: sp.downsample_keys(keys, shape, cap, y_limit))
    plain_ms = cuda_ms(lambda: sp.downsample_keys_plain(keys, shape, cap,
                                                        y_limit))
    b = keys.shape[0]
    cands = sp.downsample_candidates(keys, shape, y_limit)
    if b == 1:
        cands = cands[0]
    else:
        # rows apart: each row's candidates offset by row * 2^31 (int64)
        cands = cands.to(torch.int64) + (torch.arange(
            b, device=keys.device)[:, None] << 31)
    lib_ms = cuda_ms(lambda: torch.unique(cands))
    print(f"  {name} ({at}): kernel {ms:.4f} ms ({dev_ms:.4f} replayed from "
          f"a CUDA graph), plain {plain_ms:.4f} ms; torch.unique of the "
          f"{8 * keys.numel()} candidates {lib_ms:.4f} ms")
    return dict(name=name, route="cuda",
                source="sassd_tpu_torch/csrc/downsample.cu",
                replaces="sassd_tpu/ops/sparse.py:618" if y_limit is None
                else "sassd_tpu/ops/sparse.py:590",
                max_abs_err=err, ms=ms, graph_ms=dev_ms, plain_ms=plain_ms,
                library_ms=lib_ms,
                # torch.unique reads its output's size back to the host,
                # which a CUDA graph cannot capture
                library_graph_ms=None,
                library_what="torch.unique of the candidates (sorted, "
                             "uncapped; rows apart by an offset of row x "
                             "2^31 past batch 1)",
                at=at,
                # the function's bytes: keys (and limits) in, the capped
                # levels out; 8 parent keys a row
                **bound(keys.numel() * 4 + b * cap * 4
                        + (0 if y_limit is None else b * 4),
                        8 * keys.numel()))


def voxel_keys(torch, points, n_points, vc):
    """[B, P] int32 voxel keys of padded points, INVALID_KEY where a point
    is padding or off the grid: the keys the parent design sorted."""
    dev = points.device
    pcr = torch.tensor(vc.point_cloud_range[:3], dtype=torch.float32,
                       device=dev)
    vs = torch.tensor(vc.voxel_size, dtype=torch.float32, device=dev)
    c = torch.floor((points[..., :3] - pcr) / vs).to(torch.int32)
    gx, gy, gz = (int(g) for g in vc.grid_size)
    ok = ((torch.arange(points.shape[1], device=dev)[None]
           < n_points[:, None])
          & ((c >= 0) & (c < torch.tensor([gx, gy, gz], dtype=torch.int32,
                                          device=dev))).all(-1))
    return torch.where(ok, (c[..., 2] * gy + c[..., 1]) * gx + c[..., 0],
                       torch.iinfo(torch.int32).max)


def k8_row(torch, vox, pts, n, vc, err, name, at, extra=None):
    """K8's kernel row on [1, P] points: the whole op against its plain
    version, as events and as a graph replay (its parts by kernel printed
    as a diagnostic), and the parent design's torch.sort of the same keys alone (a component of
    the old design, not a yardstick: it is not the function)."""
    fn = lambda: vox.voxelize(pts, n, vc)                      # noqa: E731
    ms = cuda_ms(fn)
    dev_ms = graph_ms(fn)
    plain_ms = cuda_ms(lambda: vox.voxelize_plain(pts, n, vc))
    keys = voxel_keys(torch, pts, n, vc)
    sort_ms = cuda_ms(lambda: torch.sort(keys, dim=1, stable=True))
    n_in = int(n.sum())
    print(f"  {name} ({at}): kernel {ms:.4f} ms ({dev_ms:.4f} replayed "
          f"from a CUDA graph), plain {plain_ms:.4f} ms; the old design's "
          f"torch.sort of the keys alone {sort_ms:.4f} ms; {fmt_split(fn)}")
    return dict(name=name, route="cuda",
                source="sassd_tpu_torch/csrc/voxelize.cu",
                replaces="sassd_tpu/ops/voxelize.py:142",
                max_abs_err=err, ms=ms, graph_ms=dev_ms, plain_ms=plain_ms,
                library_ms=None,
                library_what="none: no PyTorch call voxelizes",
                sort_ms=sort_ms, at=at, **(extra or {}),
                # the valid points in; voxels, coords and counts out; the
                # quantisation's 9 float32 operations a point
                **bound(n_in * pts.shape[2] * 4 + vc.max_voxels * (
                    vc.max_num_points * pts.shape[2] * 4 + 12 + 4),
                    9 * n_in))


def check_serving_kernels(torch, np, device, cfg, scans, anchors_bv):
    """Phase 3, K8 and K9: the device voxelizer and the anchors mask of
    raw car-config scans against their plain versions on the card; K8 also
    on a batch of two with one sample empty and on phase 9's long-range
    timing scan, K9 also on the three-class corner table."""
    from sassd_tpu_torch import serve
    from sassd_tpu_torch.config import long_range_config, multi_config
    from sassd_tpu_torch.data import kitti, synthetic
    from sassd_tpu_torch.ops import voxelize as vox

    prepared = [serve.prepare_points(p, cfg) for p in scans]
    pts = torch.from_numpy(np.stack([p for p, _ in prepared])).to(device)
    n = torch.from_numpy(np.asarray([k for _, k in prepared],
                                    np.int32)).to(device)
    lr = long_range_config()
    lr_pts, lr_n = serve.prepare_points(synthetic.long_range_scene(
        np.random.default_rng(SEED + 10))[0], lr)
    lr_pts = torch.from_numpy(lr_pts[None]).to(device)
    lr_n = torch.from_numpy(np.asarray([lr_n], np.int32)).to(device)
    n_empty = n[:2].clone()
    n_empty[1] = 0
    err8 = 0.0
    for what, p8, n8, vc in (
            (f"car scans at the {cfg.voxel.max_voxels}-voxel cap and a "
             f"frustum scan", pts, n, cfg.voxel),
            ("a batch of two, the second sample empty", pts[:2], n_empty,
             cfg.voxel),
            ("the long-range timing scan", lr_pts, lr_n, lr.voxel)):
        got = vox.voxelize(p8, n8, vc)
        ref = vox.voxelize_plain(p8, n8, vc)
        same8 = all(torch.equal(a, b) for a, b in zip(got, ref))
        err8 = max(err8, float(max((a.double() - b.double()).abs().max()
                                   for a, b in zip(got, ref))))
        n_vox = (got[1][..., 0] >= 0).sum(1).tolist()
        print(f"K8 voxelize, {what}, {tuple(p8.shape)}, n_points "
              f"{n8.tolist()}: {'bitwise equal to' if same8 else 'DIFFERS from'}"
              f" plain; voxels {n_vox} (cap {vc.max_voxels})")
        if not same8:
            fail(f"K8 differs from its plain version on {what}")
        if p8 is pts:
            coords8 = got[1]
    hw = (int(cfg.voxel.grid_size[1]), int(cfg.voxel.grid_size[0]))
    thr = cfg.data.anchor_area_threshold
    multi = multi_config()
    err9 = 0.0
    for what, cfg9, bv in (("car", cfg, anchors_bv),
                           ("three-class", multi,
                            kitti.build_anchors(multi)[1])):
        corners = serve.anchor_corner_indices(
            bv, cfg9.voxel.voxel_size, cfg9.voxel.point_cloud_range,
            cfg9.voxel.grid_size)
        lat = serve.anchor_lattice(corners, hw).to(device)
        for c in (coords8[:1], coords8[:2], coords8):
            mask = serve.anchors_mask(c, lat, thr)
            mask_ref = serve.anchors_mask_plain(c, lat.corners, hw, thr)
            same9 = torch.equal(mask, mask_ref)
            err9 = max(err9, float((mask.int() - mask_ref.int()).abs().max()))
            print(f"K9 anchors_mask, {what} corner table "
                  f"({corners.shape[0]} anchors, lattice {lat.shape}), "
                  f"coords {tuple(c.shape)} over a {hw[0]}x{hw[1]} grid: "
                  f"{'bitwise equal to' if same9 else 'DIFFERS from'} plain; "
                  f"anchors kept {mask.sum(1).tolist()}")
            if not same9:
                fail(f"K9 differs from its plain version ({what})")
        if what == "car":
            car = lat

    p1, n1, c1 = pts[:1], n[:1], coords8[:1].contiguous()
    p2, n2 = pts[:2], n[:2]
    b2_ms = cuda_ms(lambda: vox.voxelize(p2, n2, cfg.voxel))
    b2_graph_ms = graph_ms(lambda: vox.voxelize(p2, n2, cfg.voxel))
    print(f"  K8 batch 2 (car scans 0-1): kernel {b2_ms:.4f} ms "
          f"({b2_graph_ms:.4f} replayed from a CUDA graph)")
    rows = [k8_row(torch, vox, p1, n1, cfg.voxel, err8, "K8 voxelize",
                   "batch 1 car scan, 65,536-point cap",
                   dict(batch2_ms=b2_ms, batch2_graph_ms=b2_graph_ms)),
            k8_row(torch, vox, lr_pts, lr_n, lr.voxel, err8,
                   "K8 voxelize, long range",
                   "batch 1, phase 9's long-range timing scan, "
                   "262,144-point cap, 80,000 voxels")]
    lat, ct = car, car.corners

    def k9(c):
        return serve.anchors_mask(c, lat, thr)

    c2 = coords8[:2].contiguous()
    t1 = timed(lambda: k9(c1))
    t2 = timed(lambda: k9(c2))
    # all but the scatter: the call on no voxels
    none_ms = graph_ms(lambda: k9(c1[:, :0]))
    plain_ms = cuda_ms(lambda: serve.anchors_mask_plain(c1, ct, hw, thr))
    n_anchors = ct.shape[0]
    # an estimate, printed only: the design's floor, which adds the
    # lattice written once and read once to the function's bytes
    cells = lat.shape[0] * lat.shape[1]
    floor_ms = bound(c1.shape[1] * 12 + n_anchors * 17 + 2 * cells * 4,
                     0)["bound_ms"]
    print(f"  K9 car batch 1: kernel {fmt_timed(t1)}, plain {plain_ms:.4f} "
          f"ms; batch 2 {fmt_timed(t2)}; on no voxels (all but the "
          f"scatter) {none_ms:.4f} replayed (a call replayed alone reads "
          f"0.008-0.015 ms even for a memset); lattice design floor "
          f"(estimate, not the bound) {floor_ms:.4f} ms; "
          f"{fmt_split(lambda: k9(c1))}")
    rows.append(dict(name="K9 anchors_mask", route="cuda",
                     source="sassd_tpu_torch/csrc/anchors_mask.cu",
                     replaces="sassd_tpu/serve.py:106",
                     max_abs_err=err9, **t1, batch2_ms=t2["ms"],
                     batch2_graph_ms=t2["graph_ms"],
                     no_voxels_graph_ms=none_ms, plain_ms=plain_ms,
                     library_ms=None,
                     library_what="none: the occupancy scatter, two "
                                  "cumsums and the corner reads are "
                                  "separate calls",
                     at="batch 1, 20,000 voxels, 70,400 anchors",
                     # coords and corner indices in, the mask out
                     **bound(c1.shape[1] * 12 + n_anchors * 17,
                             c1.shape[1] + 4 * n_anchors)))
    return rows


def ring_interp_level(torch, what, query, cell0, level, feats, plan, vs, pc,
                      cot) -> dict:
    """K11 at one level: rows, weights and output bitwise its plain
    version's (the signs of zeros included), the feature gradient within
    TRAIN_GRAD_RTOL of autograd through the plain version. Timed by
    events and graph replay, each in its own graph: the forward (one
    kernel), the backward (its memset of d_feats and its kernel), that
    memset alone (the backward called with no query) and the zeroing as
    the parent wrapper made it (torch.zeros); forward + backward replayed
    from one graph; the plain version; index_add_, the backward's one-call
    yardstick. Bounds: a padded query (cell z < 0)
    reads its cell and writes its output row and its rows and weights; a
    valid one also reads its point and its plan, and in the backward its
    d_out row and its rows and weights; each selected feature row is read
    once, d_feats written once."""
    from sassd_tpu_torch.ops import interpolate as itp
    from sassd_tpu_torch.ops.cuda import same_bits
    b, m, c = feats.shape
    args = (query, cell0, level, feats, plan, vs, pc)
    out, rsel, wsel = itp.ring_interp_fwd(*args)
    ref_rows, ref_w = itp.ring_select_plain(query, cell0, level, plan, m, vs,
                                            pc)
    same = (torch.equal(rsel.long(), ref_rows)
            and same_bits(wsel, ref_w)
            and same_bits(out,
                          itp.neighborhood_interpolate_cells_plain(*args)))
    fk = feats.clone().requires_grad_()
    itp.neighborhood_interpolate_cells(query, cell0, level, fk, plan, vs,
                                       pc).backward(cot)
    fp = feats.clone().requires_grad_()
    out_p = itp.neighborhood_interpolate_cells_plain(query, cell0, level, fp,
                                                     plan, vs, pc)
    err = rel_err(fk.grad, torch.autograd.grad(out_p, fp, cot,
                                               retain_graph=True)[0])
    valid = cell0[..., 0] >= 0
    q_v, q_p = int(valid.sum()), int((~valid).sum())
    print(f"K11 ring_interp{what} level {level} {tuple(query.shape)} -> "
          f"{tuple(out.shape)}, {q_p} padded queries: forward, rows and "
          f"weights {'bitwise equal to' if same else 'DIFFER from'} plain; "
          f"backward rel err {err:.3g} (tol {TRAIN_GRAD_RTOL})")
    if not same or err > TRAIN_GRAD_RTOL:
        fail(f"K11{what} disagrees with its plain version at level {level}")

    def fwd():
        return itp.ring_interp_fwd(*args)

    def bwd():
        return itp.ring_interp_bwd(cot, rsel, wsel, feats.shape)

    def both():
        _, r, w = fwd()
        return itp.ring_interp_bwd(cot, r, w, feats.shape)

    def zero():
        return torch.zeros(feats.shape, device=feats.device)

    def memset():                           # the backward with no query
        return itp.ring_interp_bwd(cot[:, :0], rsel[:0], wsel[:0],
                                   feats.shape)
    both_graph = graph_ms(both)
    t_fwd, t_bwd, t_zero = timed(fwd), timed(bwd), timed(zero)
    t_set = timed(memset)
    plain_ms = grad_ms(out_p, fp, cot) + cuda_ms(
        lambda: itp.neighborhood_interpolate_cells_plain(*args))
    src = (cot[:, :, None] * wsel.view(b, -1, 3, 1)).reshape(-1, c)
    flat = torch.zeros((b * m, c), device=feats.device)
    lib_ms = cuda_ms(lambda: flat.index_add_(0, rsel.view(-1).long(), src))
    n_rows = int(torch.unique(rsel).numel())
    org = pc.numel() * 4 if torch.is_tensor(pc) else 0
    # 17 float32 operations a tap's distance, 5 a channel of the sum; 6 a
    # channel of the backward
    bd_fwd = bound(q_v * (24 + 27 * plan.element_size() + 4 * c + 24)
                   + q_p * (12 + 4 * c + 24) + n_rows * c * 4 + org,
                   q_v * 27 * 17 + (q_v + q_p) * 5 * c)
    bd_bwd = bound(q_v * (4 * c + 24) + feats.numel() * 4, q_v * 6 * c)
    bd_zero = bound(feats.numel() * 4, 0)
    print(f"  K11{what} level {level}: forward {fmt_timed(t_fwd)}, bound "
          f"{bd_fwd['bound_ms']:.4f}; backward {fmt_timed(t_bwd)}, bound "
          f"{bd_bwd['bound_ms']:.4f}, of which its memset alone "
          f"{fmt_timed(t_set)}; zeroing as the parent made it (torch.zeros) "
          f"{fmt_timed(t_zero)}; zeroing bound {bd_zero['bound_ms']:.4f}; "
          f"forward + backward replayed {both_graph:.4f} ms; plain "
          f"{plain_ms:.4f} ms; index_add_ (backward) {lib_ms:.4f} ms")
    print(f"    forward {fmt_split(fwd)}; backward {fmt_split(bwd)}")
    return dict(err=err, ms=t_fwd["ms"] + t_bwd["ms"], graph_ms=both_graph,
                plain_ms=plain_ms, library_backward_ms=lib_ms, queries=q_v,
                padded_queries=q_p, forward=dict(**t_fwd, **bd_fwd),
                backward=dict(**t_bwd, **bd_bwd), memset=dict(**t_set,
                                                              **bd_zero),
                zeroing_torch=dict(**t_zero, **bd_zero),
                **add_bounds([bd_fwd, bd_bwd]))


def ring_interp_row(levels: dict, name: str, replaces: str, at: str) -> dict:
    """The kernel row of K11 (or K11') from ring_interp_level's results:
    ms by events (forward + backward), graph_ms replayed (the same, one
    graph a level), summed over the levels."""
    return dict(name=name, route="cuda",
                source="sassd_tpu_torch/csrc/interpolate.cu",
                replaces=replaces,
                max_abs_err=max(d["err"] for d in levels.values()),
                err_kind="backward, relative to max |plain|; the forward is "
                         "bitwise",
                ms=sum(d["ms"] for d in levels.values()),
                graph_ms=sum(d["graph_ms"] for d in levels.values()),
                plain_ms=sum(d["plain_ms"] for d in levels.values()),
                library_ms=None,
                library_what="none for the forward (the 27-tap selection "
                             "takes several calls); index_add_ of the "
                             "weighted d_out rows for the backward alone "
                             "(library_backward_ms)",
                library_backward_ms=sum(d["library_backward_ms"]
                                        for d in levels.values()),
                at=f"{at}, forward + backward (with the d_feats zeroing)",
                per_level={lv: {k: v for k, v in d.items() if k != "err"}
                           for lv, d in levels.items()},
                **add_bounds(list(levels.values())))


def k3b_check(torch, what, part_map, boxes3, valid, d_score, args):
    """K3b on one set of inputs: within TRAIN_GRAD_RTOL of autograd of the
    plain version, and d_map and d_boxes bitwise equal over two calls.
    Returns the error and the plain version's leaves and output."""
    from sassd_tpu_torch.ops import warp
    from sassd_tpu_torch.ops.cuda import same_bits
    d_map, d_boxes = warp.pswarp_score_grad(part_map, boxes3, valid, d_score,
                                            *args)
    again = warp.pswarp_score_grad(part_map, boxes3, valid, d_score, *args)
    pm, pb = part_map.clone().requires_grad_(), boxes3.clone(
        ).requires_grad_()
    out_p = warp.pswarp_score_plain(pm, pb, valid, *args)
    ref_map, ref_boxes = torch.autograd.grad(out_p, (pm, pb), d_score,
                                             retain_graph=True)
    err_map, err_boxes = rel_err(d_map, ref_map), rel_err(d_boxes, ref_boxes)
    same = same_bits(again[0], d_map) and same_bits(again[1], d_boxes)
    print(f"K3b pswarp_score_grad on {what}, {tuple(part_map.shape)} x "
          f"{boxes3.shape[1]} boxes ({int(valid.sum())} valid): rel err map "
          f"{err_map:.3g}, boxes {err_boxes:.3g} (tol {TRAIN_GRAD_RTOL}); "
          f"two calls {'bitwise equal' if same else 'DIFFER'}")
    if not max(err_map, err_boxes) <= TRAIN_GRAD_RTOL:
        fail(f"K3b disagrees with autograd of the plain version on {what}")
    if not same:
        fail(f"K3b: two calls on {what} differ")
    return max(err_map, err_boxes), (pm, pb, out_p)


def k12_check(torch, what, query, pvalid, gt, gv):
    """K12 against its plain version on the same inputs, bitwise (labels
    and offsets); fails otherwise. Returns the kernel's (label, offsets)
    and the offsets' largest absolute difference from the plain version's."""
    from sassd_tpu_torch.core import boxes
    from sassd_tpu_torch.ops.cuda import same_bits
    label, off = boxes.aux_targets(query, pvalid, gt, gv)
    ref_label, ref_off = boxes.aux_targets_plain(query, pvalid, gt, gv)
    same = torch.equal(label, ref_label) and same_bits(off, ref_off)
    print(f"K12 aux_targets on {what}, {tuple(query.shape)} x "
          f"{tuple(gt.shape)} ({int(gv.sum())} valid boxes): "
          f"{'bitwise equal to' if same else 'DIFFERS from'} plain")
    if not same:
        fail(f"K12 differs from its plain version on {what}")
    return label, off, float((off - ref_off).abs().max())


def k12_bound(torch, query, pvalid, gt, gv, label, off) -> dict:
    """K12's bound: points, validity, boxes and slots read once, labels and
    offsets written once; operations: 15 a point-box test (two
    differences, the rotation's four products and two sums, three
    absolute values and compares, the z difference) over the pairs this
    run's data tests (a valid point walks the valid boxes up to its first
    hit), and 40 a valid box for its sine and cosine."""
    from sassd_tpu_torch.core import boxes
    flags = (boxes.points_in_boxes3d(query, gt)[0] & gv[:, None, :]
             & pvalid[..., None])
    rank = torch.cumsum(gv.to(torch.int64), 1)          # 1-based among valid
    first = torch.argmax(flags.to(torch.uint8), -1)
    tested = torch.where(flags.any(-1), torch.gather(rank, 1, first),
                         rank[:, -1:].expand_as(first))
    pairs = int(tested[pvalid].sum())
    return dict(**bound(query.numel() * 4 + pvalid.numel() + gt.numel() * 4
                        + gv.numel() + label.numel() + off.numel() * 4,
                        15 * pairs + 40 * int(gv.sum())),
                pairs_tested=pairs)


def check_train_kernels(torch, np, device, cfg, samples, gts):
    """Phase 3, the training kernels at batch 2 on the train plans of the
    first two car scans: K10 and K4's input gradients, K11, K12, K3b, K5b.
    gts: [2, max_gt, 7] GT boxes and [2, max_gt] validity (the scenes')."""
    from sassd_tpu_torch.core import boxes
    from sassd_tpu_torch.ops import sparse as sp
    from sassd_tpu_torch.ops import warp

    rng = np.random.default_rng(SEED + 4)
    batch = {k: torch.from_numpy(np.stack([s[k] for s in samples[:2]])).to(
        device) for k in samples[0] if k != "meta"}
    caps = (cfg.voxel.max_voxels,) + tuple(cfg.caps.level_caps[1:])
    shapes = [cfg.sparse_shape]
    for _ in range(3):
        shapes.append(sp.out_shape_stride2(shapes[-1]))

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).to(device)
    rows = []

    # K10, and K4 as the input gradient, at the ladder's 10 convs (7
    # distinct shapes; the first conv's input takes no gradient): K4 runs
    # the subm plan with the tap-reversed transposed weights, or the stride
    # conv's transpose plan with the transposed weights
    k10, k4dx = [], []
    for name, plan_key, level_in, cin, cout, mult in LADDER:
        plan = batch[plan_key]
        x = randn(2, caps[level_in], cin)
        w = randn(27, cin, cout, scale=1 / np.sqrt(27 * cin))
        cot = randn(2, plan.shape[2], cout)
        dw = sp.conv_weight_grad(x, plan, cot)
        dw2 = sp.conv_weight_grad(x, plan, cot)
        dw_ref = sp.conv_weight_grad_plain(x, plan, cot)
        err = rel_err(dw, dw_ref)
        if not torch.equal(dw, dw2):
            fail(f"K10 gives two different weight gradients on {name}")
        ms = cuda_ms(lambda: sp.conv_weight_grad(x, plan, cot))
        plain_ms = cuda_ms(lambda: sp.conv_weight_grad_plain(x, plan, cot))
        found = int((plan >= 0).sum())
        bd = bound(x.numel() * 4 + cot.numel() * 4
                   + plan.numel() * plan.element_size() + dw.numel() * 4,
                   2 * found * cin * cout)
        print(f"K10 conv_weight_grad {name} x{mult} {plan_key[5:]} "
              f"{cin}->{cout} {tuple(plan.shape)}: found slots "
              f"{found / plan.numel():.4f}; rel err {err:.3g} (tol "
              f"{TRAIN_GRAD_RTOL}), two calls bitwise equal; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})")
        if not err <= TRAIN_GRAD_RTOL:
            fail(f"K10 disagrees with its plain version on {name}")
        k10.append((name, mult, err, ms, plain_ms, found / plan.numel(), bd))
        if cin == 4:
            continue
        if plan_key.startswith("plan_subm"):
            fn, args = sp.subm_conv_sym, (plan,)
            dx_plan = plan
            w_dx = w.flip(0).transpose(1, 2).contiguous()
        else:
            dx_plan = batch["plan_strideT" + plan_key[-1]]
            fn, args = sp.stride_conv_hostT, (plan, dx_plan)
            w_dx = w.transpose(1, 2).contiguous()
        xk, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
        fn(xk, w, *args).backward(cot)
        sp.subm_conv_batched_plain(xp, w, plan).backward(cot)
        dx_err = rel_err(xk.grad, xp.grad)
        ms = cuda_ms(lambda: sp.subm_conv_batched(cot, w_dx, dx_plan))
        plain_ms = cuda_ms(lambda: sp.subm_conv_batched_plain(cot, w_dx,
                                                              dx_plan))
        found = int((dx_plan >= 0).sum())
        bd = bound(cot.numel() * 4 + dx_plan.numel() * dx_plan.element_size()
                   + w_dx.numel() * 4 + x.numel() * 4,
                   2 * found * cin * cout)
        print(f"  K4 input gradient {name} x{mult} on "
              f"{'the subm plan' if dx_plan is plan else 'strideT'} "
              f"{tuple(dx_plan.shape)} {cout}->{cin}: found slots "
              f"{found / dx_plan.numel():.4f}; rel err {dx_err:.3g} (tol "
              f"{TRAIN_GRAD_RTOL}); kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms "
              f"({bd['bound_by']})")
        if not dx_err <= TRAIN_GRAD_RTOL:
            fail(f"K4's input gradient disagrees on {name}")
        k4dx.append((name, mult, dx_err, ms, plain_ms,
                     found / dx_plan.numel(), bd))
    rows.append(dict(name="K10 conv_weight_grad", route="cuda",
                     source="sassd_tpu_torch/csrc/sparse_conv_bwd.cu",
                     replaces="sassd_tpu/ops/sparse.py:541",
                     max_abs_err=max(e for _, _, e, *_ in k10),
                     err_kind="relative to max |plain|; two calls bitwise "
                              "equal",
                     ms=sum(n * m for _, n, _, m, *_ in k10),
                     plain_ms=sum(n * m for _, n, _, _, m, *_ in k10),
                     library_ms=None,
                     library_what="none: each tap's row gathers and its "
                                  "product are separate calls",
                     at="batch 2, one train step's weight gradients: the "
                        "ladder's 10 convs, launches x ms summed",
                     per_shape={name: dict(convs=n, ms=m, plain_ms=pm,
                                           found_frac=ff, **bd)
                                for name, n, _, m, pm, ff, bd in k10},
                     input_grad=dict(
                         kernel="K4", max_rel_err=max(e for _, _, e, *_
                                                      in k4dx),
                         ms=sum(n * m for _, n, _, m, *_ in k4dx),
                         plain_ms=sum(n * m for _, n, _, _, m, *_ in k4dx),
                         at="batch 2, the 9 convs whose input takes a "
                            "gradient, launches x ms summed",
                         per_shape={name: dict(convs=n, ms=m, plain_ms=pm,
                                               found_frac=ff, **bd)
                                    for name, n, _, m, pm, ff, bd in k4dx},
                         **add_bounds([bd for _, n, *_, bd in k4dx
                                       for _ in range(n)])),
                     **add_bounds([bd for _, n, *_, bd in k10
                                   for _ in range(n)])))

    # K11 at the three levels: forward bitwise with identical selections,
    # backward within TRAIN_GRAD_RTOL
    npts = torch.clamp(batch["num_points"], min=1)[..., None].float()
    query = (batch["voxels"][..., :3].sum(-2) / npts).contiguous()
    cell0 = batch["coords"]
    pc = np.asarray(cfg.voxel.point_cloud_range[:3], np.float32).tolist()
    k11 = {}
    for level, c in ((1, 32), (2, 64), (3, 64)):
        vs = (np.asarray(cfg.voxel.voxel_size, np.float32)
              * 2 ** level).tolist()
        k11[level] = ring_interp_level(
            torch, "", query, cell0, level, randn(2, caps[level], c),
            batch[f"plan_aux{level}"], vs, pc,
            randn(*query.shape[:2], c))
    rows.append(ring_interp_row(
        k11, "K11 ring_interp", "sassd_tpu/ops/interpolate.py:115",
        "batch 2, levels 1-3"))

    # K12: the voxel centroids of the two scans against their GT boxes
    pvalid = batch["coords"][..., 0] >= 0
    gt, gv = (torch.from_numpy(a).to(device) for a in gts)
    label, off, err12 = k12_check(torch, "phase 3's inputs", query, pvalid,
                                  gt, gv)
    print(f"  K12 points in boxes {label.sum(1).tolist()}")
    if not label.any():
        fail("K12: no point of phase 3's scans is in a GT box")
    t12 = measured(lambda: boxes.aux_targets(query, pvalid, gt, gv),
                   "K12 aux_targets, batch 2", iters=100)
    plain_ms = cuda_ms(lambda: boxes.aux_targets_plain(query, pvalid, gt,
                                                       gv))
    rows.append(dict(name="K12 aux_targets", route="cuda",
                     source="sassd_tpu_torch/csrc/points_in_boxes.cu",
                     replaces="sassd_tpu/core/boxes.py:281",
                     max_abs_err=err12, **t12,
                     plain_ms=plain_ms, library_ms=None,
                     library_what="none: torch has no points-in-rotated-"
                                  "boxes test",
                     at="batch 2, 20,000-voxel cap, 64 GT slots",
                     **k12_bound(torch, query, pvalid, gt, gv, label, off)))

    # K3b: [2, 28, 200, 176] part map, 640 guided boxes a sample
    b, k, h, w, n = 2, 28, 200, 176, cfg.caps.guided_train
    part_map = randn(b, k, h, w)
    bx = np.zeros((b, n, 7), np.float32)
    bx[..., 0] = rng.uniform(0, 70.4, (b, n))
    bx[..., 1] = rng.uniform(-40, 40, (b, n))
    bx[..., 2] = -1.7
    bx[..., 3:6] = rng.uniform([1.4, 3.2, 1.4], [1.9, 4.5, 1.8], (b, n, 3))
    bx[..., 6] = rng.uniform(-np.pi, np.pi, (b, n))
    boxes3 = torch.from_numpy(bx).to(device)
    valid = torch.from_numpy(rng.uniform(size=(b, n)) < 0.9).to(device)
    d_score = randn(b, n)
    args = (cfg.model.window_size, cfg.model.grid_offsets,
            1.0 / cfg.model.featmap_stride)

    def k3b():
        return warp.pswarp_score_grad(part_map, boxes3, valid, d_score, *args)
    err3b, (pm, pb, out_p) = k3b_check(torch, "phase 3's inputs", part_map,
                                       boxes3, valid, d_score, args)
    t3b = timed(k3b)
    plain_ms = grad_ms(out_p, (pm, pb), d_score)
    print(f"  K3b: kernel {fmt_timed(t3b)}, plain (autograd) {plain_ms:.4f} "
          f"ms; {fmt_split(k3b)}")
    print(f"  K3b {host_split(k3b)[1]}")
    heights = []                    # pass B's tile height, replayed
    default_rows = warp.K3B_TILE_ROWS
    try:
        for rows_b in K3B_ROWS_TRIED:
            warp.K3B_TILE_ROWS = rows_b
            heights.append(f"{rows_b} rows {graph_ms(k3b):.4f}")
    finally:
        warp.K3B_TILE_ROWS = default_rows
    print(f"  K3b replayed by pass B's tile height (diagnostic; "
          f"{default_rows} in use): {', '.join(heights)} ms")
    zeros_ms = graph_ms(lambda: torch.zeros((b, k, h, w), device=device))
    print(f"  lone replay, not a kernel row: torch.zeros of K3b's d_map "
          f"{(b, k, h, w)}, {zeros_ms:.4f} ms")
    rows.append(dict(name="K3b pswarp_score_grad", route="cuda",
                     source="sassd_tpu_torch/csrc/pswarp_score.cu",
                     replaces="sassd_tpu/ops/warp.py:76",
                     max_abs_err=err3b, err_kind="relative to max |plain|",
                     **t3b, plain_ms=plain_ms, library_ms=None,
                     library_what="none: as K3, grid_sample's backward "
                                  "covers every channel at every point",
                     at="batch 2, 640 boxes a sample",
                     # d_score, boxes, valid, 4 map taps a part in; the
                     # whole d_map (zeros included) and d_boxes out; ~100
                     # operations a part
                     **bound(b * n * (4 + 28 + 1 + 28) + b * n * k * 16
                             + part_map.numel() * 4, b * n * k * 100)))

    # K5b: the level-3 rows of both scans from a [2, 320, 200, 176] canvas
    keys3 = sp.coords_to_keys(batch["plan_coords3"], shapes[3])
    d3, h3, w3 = shapes[3]
    d_canvas = randn(2, d3 * 64, h3, w3)
    got = sp.densify_grad(keys3, d_canvas, shapes[3])
    ref = sp.densify_grad_plain(keys3, d_canvas, shapes[3])
    same5b = torch.equal(got, ref)
    print(f"K5b densify_grad {tuple(d_canvas.shape)} -> {tuple(got.shape)}:"
          f" {'bitwise equal to' if same5b else 'DIFFERS from'} plain")
    if not same5b:
        fail("K5b differs from its plain version")
    ms = cuda_ms(lambda: sp.densify_grad(keys3, d_canvas, shapes[3]),
                 iters=100)
    dev_ms = graph_ms(lambda: sp.densify_grad(keys3, d_canvas, shapes[3]),
                      iters=100)
    plain_ms = cuda_ms(lambda: sp.densify_grad_plain(keys3, d_canvas,
                                                     shapes[3]))
    n_rows = int((keys3 != sp.INVALID_KEY).sum())
    # the one-call yardstick: one gather of the active rows from the
    # [B, D, C, H, W] view of the canvas gradient
    bzyx = keys_bzyx(torch, keys3, shapes[3])
    dv = d_canvas.view(2, d3, 64, h3, w3)

    def gather5b():
        return dv[bzyx[0], bzyx[1], :, bzyx[2], bzyx[3]]
    lib_ms = cuda_ms(gather5b, iters=100)
    lib_graph_ms = graph_ms(gather5b, iters=100)
    # the replays reread the same sectors of the 90 MB canvas, at most
    # 42 MB at one 32-byte sector an active (row, channel), which the 50 MB
    # L2 can
    # keep between calls; the cold-L2 times need no such luck
    cold = cold_ms(lambda: sp.densify_grad(keys3, d_canvas, shapes[3]))
    lib_cold = cold_ms(gather5b)
    # an estimate for a cold L2, printed only: one 32-byte sector per
    # active (row, channel), the row's values lying H*W floats apart
    sector_ms = n_rows * 64 * 32 / HBM_BYTES_PER_S * 1e3
    print(f"  K5b kernel {ms:.4f} ms ({dev_ms:.4f} replayed from a CUDA "
          f"graph, L2 warm; {cold:.4f} with the L2 cold), plain "
          f"{plain_ms:.4f} ms; one-call yardstick (gather of the active "
          f"rows) {lib_ms:.4f} ms ({lib_graph_ms:.4f} replayed; "
          f"{lib_cold:.4f} cold); {n_rows} active rows, sector estimate "
          f"(L2 cold) {sector_ms:.4f} ms")
    rows.append(dict(name="K5b densify_grad", route="cuda",
                     source="sassd_tpu_torch/csrc/densify.cu",
                     replaces="sassd_tpu/ops/sparse.py:835",
                     max_abs_err=float((got - ref).abs().max()), ms=ms,
                     graph_ms=dev_ms, cold_l2_ms=cold, plain_ms=plain_ms,
                     library_ms=lib_ms, library_graph_ms=lib_graph_ms,
                     library_cold_l2_ms=lib_cold,
                     library_what="one advanced-index gather of the active "
                                  "rows (padding rows not zeroed)",
                     at="batch 2, 10,240-row cap",
                     # keys and the active rows' canvas values in, rows out
                     **bound(keys3.numel() * 4 + n_rows * 64 * 4
                             + got.numel() * 4, 0)))
    return rows


def k14_bound(torch, cell0, shapes) -> dict:
    """K14's bound: cell0 read once, the three [B, 27, M0] int32 plans
    written once, and each level's map read once at the distinct in-grid
    cells of the valid rows' 3x3x3 windows (key-sorted neighbours share
    most of them)."""
    b, m0, _ = cell0.shape
    valid = cell0[..., 0] >= 0
    rows = cell0[valid].to(torch.int64)
    sample = torch.arange(b, device=cell0.device)[:, None].expand(b, m0)[
        valid][:, None]
    taps = torch.tensor([(dz, dy, dx) for dz in (-1, 0, 1)
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
                        device=cell0.device)
    cells = 0
    for lvl, (d, h, w) in enumerate(shapes, 1):
        q = (rows >> lvl)[:, None, :] + taps                   # [n, 27, 3]
        ok = ((q >= 0) & (q < torch.tensor([d, h, w],
                                           device=cell0.device))).all(-1)
        lin = ((sample * d + q[..., 0]) * h + q[..., 1]) * w + q[..., 2]
        cells += int(torch.unique(lin[ok]).numel())
    return dict(**bound(cell0.numel() * 4 + 3 * b * 27 * m0 * 4 + cells * 4,
                        0), map_cells_read=cells)


def k13_bound(torch, keys, shapes) -> dict:
    """K13's bound: the keys of levels 0-2 read once, the three [B, 27, M]
    int32 plans written once, and each distinct 32-byte sector of the
    level maps that a live tap reads (a sector is the least the card
    reads), at this run's rows."""
    from sassd_tpu_torch.ops import sparse as sp
    dev = keys[0].device
    taps = torch.tensor([(dz, dy, dx) for dz in (-1, 0, 1)
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
                        device=dev)
    nbytes = sectors = live_taps = 0
    for lvl, k in enumerate(keys):
        b, m = k.shape
        nbytes += k.numel() * 4 + 27 * k.numel() * 4
        c = sp.keys_to_coords(k, shapes[lvl]).to(torch.int64)
        valid = c[..., 0] >= 0
        q = c[valid][:, None, :] - taps                        # [n, 27, 3]
        od, oh, ow = shapes[lvl + 1]
        live = ((q >= 0) & (q % 2 == 0)
                & (q // 2 < torch.tensor([od, oh, ow], device=dev))).all(-1)
        p = q // 2
        sample = torch.arange(b, device=dev)[:, None].expand(b, m)[valid]
        lin = (sample[:, None] * (od * oh * ow)
               + (p[..., 0] * oh + p[..., 1]) * ow + p[..., 2])
        sectors += int(torch.unique(lin[live] // 8).numel())
        live_taps += int(live.sum())
    return dict(**bound(nbytes + sectors * 32, 0), map_sectors_read=sectors,
                live_taps=live_taps)


def k13_check(torch, what: str, keys, maps, shapes, strides, host=None):
    """K13's one call for the three levels (keys of levels 0-3, index maps
    of levels 1-3, the four grids) held bitwise against its plain version,
    the forward stride plans inverted and, where given, the C++ train
    rulebook's strideT plans; read four ways by measured() beside its
    yardstick (torch.full + index_put_ of the forward plans' found
    entries, the three levels, also by measured()). Returns its row."""
    from sassd_tpu_torch.ops import sparse as sp
    sys.path.insert(0, os.path.join(HERE, "tests"))
    # the parent design, the forward plans inverted: the tests' oracle
    from test_torch_cases import invert_stride_plan

    def k13():
        return sp.stride_plans_T(keys[:3], maps, shapes)
    got = k13()
    ref = sp.stride_plans_T_plain(keys[:3], maps, shapes)
    diff, puts = {}, []
    for lvl, (g, r, fwd) in enumerate(zip(got, ref, strides), 1):
        inv = invert_stride_plan(fwd, keys[lvl - 1].shape[1])
        diff[f"strideT{lvl}"] = (int((g != r).sum()), int((g != inv).sum()),
                                 None if host is None
                                 else int((g != host[lvl - 1]).sum()))
        bk, kk, oo = torch.nonzero(fwd >= 0, as_tuple=True)
        puts.append((tuple(g.shape), (bk, kk, fwd[bk, kk, oo].long()),
                     oo.to(torch.int32)))
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    print(f"K13 stride_plans_T, {what}: entries differing (from plain, from "
          f"the forward plans inverted, from the C++ train rulebook): "
          f"{diff}; max|kernel-plain| {err:g}")
    if any(v for d in diff.values() for v in d):
        fail(f"K13 differs from its plain version, the inverted forward "
             f"plans or the C++ train rulebook ({what})")

    def put13():
        for shape, idx, val in puts:
            out = torch.full(shape, -1, dtype=torch.int32,
                             device=keys[0].device)
            out.index_put_(idx, val)
    t = measured(k13, f"K13 stride_plans_T, {what}", iters=100)
    lib = measured(put13, f"K13's yardstick (torch.full + index_put_, three "
                          f"levels), {what}", iters=100)
    plain_ms = cuda_ms(lambda: sp.stride_plans_T_plain(keys[:3], maps,
                                                       shapes))
    bd = k13_bound(torch, keys[:3], shapes)
    print(f"  K13 bound, {what}: {bd['bound_ms']:.4f} ms (bytes: plans "
          f"written, keys read, {bd['map_sectors_read']} map sectors of 32 "
          f"bytes for {bd['live_taps']} live taps); plain {plain_ms:.4f} ms")
    return dict(name="K13 stride_plans_T", route="cuda",
                source="sassd_tpu_torch/csrc/device_plans.cu",
                replaces="sassd_tpu/ops/sparse.py:732", max_abs_err=err,
                **t, plain_ms=plain_ms, library_ms=lib["ms"],
                library_graph_ms=lib["graph_ms"],
                library_profiler_ms=lib["profiler_ms"],
                library_host_us=lib["host_us"],
                library_what="torch.full(-1) + index_put_ of the forward "
                             "plans' found entries, the three levels",
                at=what, **bd)


def level_centers(np, cfg, coords, level):
    """Cell centres [B, M, 3] xyz of a level's zyx coords (the aux branch's
    known points of the exact 3-NN)."""
    from sassd_tpu_torch.ops import interpolate as itp
    vs = np.asarray(cfg.voxel.voxel_size, np.float32) * 2 ** level
    pcr = np.asarray(cfg.voxel.point_cloud_range[:3], np.float32)
    return itp.cell_centers(coords, vs.tolist(), pcr.tolist())


def check_train_plan_kernels(torch, np, device, cfg, samples):
    """Phase 3, the kernels of training without host plans, at batch 2 on
    the train plans of the first two car scans: K13 (transpose plans, also
    against the forward plans inverted) and K14 (aux ring plans) against
    their plain versions and the C++ train rulebook, bitwise; K15 (exact
    3-NN) against its plain version at the full level sizes: rows, weights
    and features bitwise, and its backward (K11's) within
    TRAIN_GRAD_RTOL."""
    from sassd_tpu_torch.ops import interpolate as itp
    from sassd_tpu_torch.ops import sparse as sp

    rng = np.random.default_rng(SEED + 5)
    batch = {k: torch.from_numpy(np.stack([s[k] for s in samples[:2]])).to(
        device) for k in samples[0] if k != "meta"}
    caps = (cfg.voxel.max_voxels,) + tuple(cfg.caps.level_caps[1:])
    shapes = [cfg.sparse_shape]
    for _ in range(3):
        shapes.append(sp.out_shape_stride2(shapes[-1]))
    cell0 = batch["coords"]
    rows = []

    # K13: the three levels' transpose plans in one call, from the keys of
    # levels 0-2 and the index maps of levels 1-3 (K14 reads the same maps)
    keys = [sp.coords_to_keys(cell0, shapes[0])] + [
        sp.coords_to_keys(batch[f"plan_coords{lvl}"], shapes[lvl])
        for lvl in (1, 2, 3)]
    maps = [sp.build_index_map(k, s) for k, s in zip(keys[1:], shapes[1:])]
    rows.append(k13_check(
        torch, "batch 2, levels 1-3 in one call", keys, maps, shapes,
        [batch[f"plan_stride{lvl}"].to(torch.int32) for lvl in (1, 2, 3)],
        [batch[f"plan_strideT{lvl}"].to(torch.int32) for lvl in (1, 2, 3)]))

    # K14: the three levels' aux plans in one call
    got = sp.aux_plans(cell0, maps, shapes[1:])
    diff, err = {}, {}
    ref = sp.aux_plans_plain(cell0, maps, shapes[1:])
    for lvl in (1, 2, 3):
        host = batch[f"plan_aux{lvl}"].to(torch.int32)
        diff[f"aux{lvl}"] = (int((got[lvl - 1] != ref[lvl - 1]).sum()),
                             int((got[lvl - 1] != host).sum()))
        err[f"aux{lvl}"] = float((got[lvl - 1] - ref[lvl - 1]).abs().max())
    print(f"K14 aux_plans, batch 2, levels 1-3: entries differing (from "
          f"plain, from the C++ train rulebook): {diff}; max|kernel-plain|: "
          f"{err}")
    if any(a or b for a, b in diff.values()):
        fail("K14 differs from its plain version or the C++ train rulebook")
    # the three-level call at batch 2 and at phase 8's batch-1 shape (one
    # scan: multi_config shares the car grid and caps)
    t14 = measured(lambda: sp.aux_plans(cell0, maps, shapes[1:]),
                   "K14 aux_plans, batch 2, levels 1-3 in one call",
                   iters=100)
    plain_ms = cuda_ms(lambda: sp.aux_plans_plain(cell0, maps, shapes[1:]))
    cell0_b1, maps_b1 = cell0[:1], [m[:1] for m in maps]
    t14_b1 = measured(lambda: sp.aux_plans(cell0_b1, maps_b1, shapes[1:]),
                      "K14 aux_plans, batch 1 (phase 8's shape)", iters=100)
    for what, c in (("batch 2", cell0), ("batch 1", cell0_b1)):
        fill = kernel_split(lambda: torch.full(
            (3, c.shape[0], 27, c.shape[1]), -1, dtype=torch.int32,
            device=device))
        print(f"  K14's plans written alone, {what} (diagnostic, not in the "
              f"row: torch.full(-1) of the [3, B, 27, M0] buffer, profiler "
              f"ms a call): {sum(fill.values()):.4f}")
    bd14, bd14_b1 = (k14_bound(torch, c, shapes[1:])
                     for c in (cell0, cell0_b1))
    print(f"  K14 aux_plans bound: batch 2 {bd14['bound_ms']:.4f} ms, "
          f"batch 1 {bd14_b1['bound_ms']:.4f} ms; plain (batch 2) "
          f"{plain_ms:.4f} ms")
    rows.append(dict(name="K14 aux_plans", route="cuda",
                     source="sassd_tpu_torch/csrc/device_plans.cu",
                     replaces="sassd_tpu/ops/sparse.py:785",
                     max_abs_err=max(err.values()),
                     **t14, plain_ms=plain_ms, library_ms=None,
                     library_what="none: the window's tap cells and edge "
                                  "masks take several calls before one "
                                  "gather",
                     at="batch 2, levels 1-3 in one call",
                     batch1=dict(t14_b1, bound_ms=bd14_b1["bound_ms"]),
                     **bd14))
    del maps, keys

    # K15 at the three levels: the voxel centroids of both scans against
    # every cell centre of the level
    npts = torch.clamp(batch["num_points"], min=1)[..., None].float()
    query = (batch["voxels"][..., :3].sum(-2) / npts).contiguous()
    k15, err15 = [], 0.0
    for lvl, c in ((1, 32), (2, 64), (3, 64)):
        coords = batch[f"plan_coords{lvl}"]
        centers = level_centers(np, cfg, coords, lvl).contiguous()
        valid = (coords[..., 0] >= 0).contiguous()
        feats = torch.from_numpy(rng.normal(
            size=(2, caps[lvl], c)).astype(np.float32)).to(device)
        out, rsel, wsel = itp.three_nn_fwd(query, centers, valid, feats)
        ref_rows, ref_w = itp.three_nn_select_plain(query, centers, valid)
        ref = itp.three_nn_interpolate_plain(query, centers, valid, feats)
        same = (torch.equal(rsel.long(), ref_rows)
                and torch.equal(wsel, ref_w) and torch.equal(out, ref))
        fwd_err = rel_err(out, ref)
        cot = torch.from_numpy(rng.normal(size=tuple(out.shape)).astype(
            np.float32)).to(device)
        fk = feats.clone().requires_grad_()
        itp.three_nn_interpolate(query, centers, valid, fk).backward(cot)
        fp = feats.clone().requires_grad_()
        out_p = itp.three_nn_interpolate_plain(query, centers, valid, fp)
        bwd_err = rel_err(fk.grad, torch.autograd.grad(
            out_p, fp, cot, retain_graph=True)[0])
        err15 = max(err15, fwd_err, bwd_err)
        print(f"K15 three_nn level {lvl} {tuple(query.shape)} x "
              f"{tuple(centers.shape)} -> {tuple(out.shape)}: rows, "
              f"weights and output "
              f"{'bitwise equal to' if same else 'DIFFER from'} plain; "
              f"backward (K11) rel err {bwd_err:.3g} (tol {TRAIN_GRAD_RTOL})")
        if not same or bwd_err > TRAIN_GRAD_RTOL:
            fail(f"K15 disagrees with its plain version at level {lvl}")
        ms = cuda_ms(lambda: itp.three_nn_fwd(query, centers, valid, feats))
        dev_ms = graph_ms(lambda: itp.three_nn_fwd(query, centers, valid,
                                                   feats))
        bwd_ms = cuda_ms(lambda: itp.ring_interp_bwd(cot, rsel, wsel,
                                                     feats.shape))
        plain_ms = cuda_ms(lambda: itp.three_nn_interpolate_plain(
            query, centers, valid, feats), iters=3)
        plain_bwd_ms = grad_ms(out_p, fp, cot)
        q = query.shape[0] * query.shape[1]
        m = centers.shape[1]
        # queries, known points, validity, 3 feature rows a query (at most
        # the level) in; features, rows and weights out; 9 float32
        # operations a (query, known) pair: the dot (5), u2 + k2, 2 * dot,
        # the difference and the validity bias
        bd = bound(q * 12 + 2 * m * 13 + min(feats.numel(), 3 * q * c) * 4
                   + q * c * 4 + q * 24, q * m * 9)
        # an estimate, printed only: those operations issued one by one
        # (-fmad=false), with a compare and the bit it sets, 10
        # instructions a pair at one a lane and cycle
        instr_ms = q * m * 10 / INSTR_PER_S * 1e3
        print(f"  K15 level {lvl}: kernel {ms:.4f} ms ({dev_ms:.4f} "
              f"replayed from a CUDA graph), plain {plain_ms:.4f} ms; "
              f"bound {bd['bound_ms']:.4f} ms (operations), unfused "
              f"instruction estimate {instr_ms:.4f} ms")
        k15.append((lvl, ms, dev_ms, bwd_ms, plain_ms, plain_bwd_ms, bd))
    rows.append(dict(name="K15 three_nn", route="cuda",
                     source="sassd_tpu_torch/csrc/interpolate.cu",
                     replaces="sassd_tpu/ops/interpolate.py:23",
                     max_abs_err=err15, err_kind="relative to max |plain|; "
                     "rows, weights and output bitwise",
                     ms=sum(m for _, m, *_ in k15),
                     graph_ms=sum(g for _, _, g, *_ in k15),
                     plain_ms=sum(pm for *_, pm, _, _ in k15),
                     library_ms=None,
                     library_what="none: the masked distances, the top 3 "
                                  "and the weighted gather are separate "
                                  "calls (cdist has no validity mask)",
                     backward_ms=sum(bm for _, _, _, bm, *_ in k15),
                     plain_backward_ms=sum(pbm for *_, pbm, _ in k15),
                     at="batch 2, forward, levels 1-3 (backward: K11's "
                        "sassd_ring_interp_bwd)",
                     per_level={lv: dict(ms=m, graph_ms=g, backward_ms=bm,
                                         plain_ms=pm,
                                         plain_backward_ms=pbm, **bd)
                                for lv, m, g, bm, pm, pbm, bd in k15},
                     **add_bounds([bd for *_, bd in k15])))
    return rows


def check_once(sp, launches: dict, what: str, kid: str, want: int):
    """Print a kernel's launches in one train step and fail unless they
    are `want`: K13 makes the three levels' transpose plans in one launch
    on every device-plans train step, K14 the aux plans (ring aux only)."""
    n = sum(launches[s] for s in sp.KERNEL_SYMBOLS[kid])
    print(f"{what}: {kid} (three levels a launch) launched {n} time(s) in "
          f"one train step (want {want})")
    if n != want:
        fail(f"{what}: {kid} launched {n} times in one step, not {want}")


def match_detections(a, b, what: str):
    """Match two detection sets (dicts of numpy, one sample) within the
    tolerances; returns the number of detections."""
    import numpy as np
    va, vb = a["valid"], b["valid"]
    if va.sum() != vb.sum():
        fail(f"{what}: {va.sum()} vs {vb.sum()} detections")
    ba, sa = a["boxes"][va], a["scores"][va]
    bb, sb = b["boxes"][vb], b["scores"][vb]
    used = np.zeros(len(bb), bool)
    for i in range(len(ba)):
        d = np.abs(bb - ba[i]).max(1)
        ok = (d <= DET_BOX_ATOL) & (np.abs(sb - sa[i]) <= DET_SCORE_ATOL)
        ok &= ~used
        if not ok.any():
            fail(f"{what}: detection {i} {ba[i]} score {sa[i]:.5f} "
                 f"has no match")
        used[np.argmax(ok)] = True
    return int(va.sum())


def run_phase(torch, np, device, cfg, model_dev, anchors, samples,
              what: str):
    """Phases 4 and 5: forward_test on the card over every sample at batch
    1 and over the first two at batch 2, with the launch counts reset just
    before and read just after. Returns (dets1, dets2, ms1, ms2,
    launches)."""
    from sassd_tpu_torch.data import kitti
    from sassd_tpu_torch.inference import make_test_step

    step = make_test_step(cfg, anchors, device)
    batch1 = [kitti.collate([s])[0] for s in samples]
    batch2 = kitti.collate(samples[:2])[0]
    for b in batch1[:1] + [batch2]:                 # warm-up (cuDNN, build)
        step(model_dev, b)
    torch.cuda.synchronize()

    reset_launches()
    dets1, ms1 = [], []
    for b in batch1:
        t = time.perf_counter()
        d = step(model_dev, b)
        torch.cuda.synchronize()
        ms1.append((time.perf_counter() - t) * 1e3)
        dets1.append({k: v.cpu().numpy() for k, v in d.items()})
    t = time.perf_counter()
    d2 = step(model_dev, batch2)
    torch.cuda.synchronize()
    ms2 = (time.perf_counter() - t) * 1e3
    launches = read_launches()
    dets2 = {k: v.cpu().numpy() for k, v in d2.items()}

    print(f"{what}: launches {launches}")
    for i, d in enumerate(dets1 + [dets2]):
        if not (np.isfinite(d["boxes"]).all()
                and np.isfinite(d["scores"]).all()):
            fail(f"{what}: non-finite detections in run {i}")
    counts = [match_detections(dets1[i], {k: v[i] for k, v in dets2.items()},
                               f"{what}, scan {i}: batch 2 vs batch 1")
              for i in range(2)]
    print(f"{what}: batch 2 agrees with batch 1 ({counts} detections); "
          f"guided candidates truncated by the cap: "
          f"{[int(d['guided_truncated'][0]) for d in dets1]}")
    return dets1, dets2, ms1, ms2, launches


def check_cpu(np, cfg, model, anchors, sample, dets, what: str):
    """One scan through the plain versions on the CPU == the card."""
    from sassd_tpu_torch.data import kitti
    from sassd_tpu_torch.inference import make_test_step
    t = time.perf_counter()
    cpu = make_test_step(cfg, anchors, "cpu")(model, kitti.collate([sample])[0])
    cpu_s = time.perf_counter() - t
    cpu = {k: v.numpy() for k, v in cpu.items()}
    n = match_detections(dets, cpu, f"{what}, scan 0: card vs CPU")
    print(f"{what}: card vs CPU (plain versions, {cpu_s:.1f} s): {n} "
          f"detections match (boxes {DET_BOX_ATOL}, scores "
          f"{DET_SCORE_ATOL})")


def unique_voxels(np, points, cfg) -> int:
    """In-range unique voxel count of a raw scan (no cap)."""
    pcr = np.asarray(cfg.voxel.point_cloud_range[:3], np.float32)
    vs = np.asarray(cfg.voxel.voxel_size, np.float32)
    c = np.floor((points[:, :3] - pcr) / vs).astype(np.int64)
    c = c[np.all((c >= 0) & (c < cfg.voxel.grid_size), axis=1)]
    return len(np.unique(c, axis=0))


def match_annos(np, a, b, what: str) -> int:
    """Two KITTI annotations of one scan equal as sets: camera-frame
    location and dimensions within the box tolerance, score within the
    score tolerance."""
    if len(a["name"]) != len(b["name"]):
        fail(f"{what}: {len(a['name'])} vs {len(b['name'])} detections")
    used = np.zeros(len(b["name"]), bool)
    for i in range(len(a["name"])):
        ok = ((np.abs(b["location"] - a["location"][i]).max(1)
               <= DET_BOX_ATOL)
              & (np.abs(b["dimensions"] - a["dimensions"][i]).max(1)
                 <= DET_BOX_ATOL)
              & (np.abs(b["score"] - a["score"][i]) <= DET_SCORE_ATOL)
              & ~used)
        if not ok.any():
            fail(f"{what}: detection {i} at {a['location'][i]} score "
                 f"{a['score'][i]:.5f} has no match")
        used[np.argmax(ok)] = True
    return len(a["name"])


def run_serving(torch, np, device, cfg, model_dev, model_cpu, root: str):
    """Phase 6: device-resident serving through run_inference and the KITTI
    evaluator. Returns (launches, ms1, ms2, host_ms, launches of one
    batch-1 step)."""
    from sassd_tpu_torch import inference, serve
    from sassd_tpu_torch.eval import results

    cfg_pts, ds, step, batch1, batch2 = serving_split(torch, np, device, cfg,
                                                      root)
    data_root = os.path.join(root, "training")
    for b in (batch1[0], batch2[0]):                 # warm-up
        step(model_dev, b)
    torch.cuda.synchronize()

    reset_launches()
    runs = {bs: inference.run_inference(cfg_pts, ds, model_dev, bs, device)
            for bs in (1, 2)}
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"serving: launches {launches}")

    host = inference.run_inference(cfg, ds, model_dev, 1, device)
    n_unique = [unique_voxels(np, ds.load_points(i)[0], cfg)
                for i in range(N_SCANS)]
    print(f"serving: in-range voxels per scan {n_unique} (cap "
          f"{cfg.voxel.max_voxels})")
    counts = []
    for i in range(N_SCANS):
        if n_unique[i] >= cfg.voxel.max_voxels:
            print(f"serving, scan {i}: over the voxel cap, the host and "
                  f"device voxelizers keep different voxels; not compared")
            continue
        counts.append(match_annos(np, runs[1][0][i], host[0][i],
                                  f"serving, scan {i}: points vs voxels"))
        match_annos(np, runs[2][0][i], runs[1][0][i],
                    f"serving, scan {i}: batch 2 vs batch 1")
    if not counts:
        fail("serving: no scan under the voxel cap to compare")
    print(f"serving: points mode agrees with voxels mode and batch 2 with "
          f"batch 1 on {len(counts)} scans ({counts} detections in the "
          f"image)")

    t = time.perf_counter()
    cpu = serve.make_serving_step(cfg_pts, ds.anchors, ds.anchors_bv,
                                  "cpu")(model_cpu, batch1[0])
    cpu_s = time.perf_counter() - t
    card = step(model_dev, batch1[0])
    n = match_detections({k: v.cpu().numpy() for k, v in card.items()},
                         {k: v.numpy() for k, v in cpu.items()},
                         "serving, scan 0: card vs CPU")
    print(f"serving: card vs CPU (plain versions, {cpu_s:.1f} s): {n} "
          f"detections match")

    annos, ids = runs[1]
    results.write_result_files(annos, ids, os.path.join(root, "results"))
    _, text = inference.evaluate(cfg_pts, ds, None,
                                 os.path.join(data_root, "label_2"),
                                 precomputed=runs[1])
    if "Car AP@" not in text:
        fail("serving: evaluate printed no AP table")
    print(f"serving: wrote {len(ids)} result files; KITTI AP (random "
          f"weights):\n{text}")

    torch.cuda.synchronize()
    reset_launches()
    step(model_dev, batch1[0])
    torch.cuda.synchronize()
    per_step = read_launches()
    ms1, ms2 = [], []
    for b in batch1:
        t = time.perf_counter()
        step(model_dev, b)
        torch.cuda.synchronize()
        ms1.append((time.perf_counter() - t) * 1e3)
    for b in batch2:
        t = time.perf_counter()
        step(model_dev, b)
        torch.cuda.synchronize()
        ms2.append((time.perf_counter() - t) * 1e3 / 2)
    raw = [ds.load_points(i)[0] for i in range(N_SCANS)]
    t = time.perf_counter()
    for p in raw:
        serve.prepare_points(p, cfg_pts)
    host_ms = (time.perf_counter() - t) * 1e3 / N_SCANS
    return launches, ms1, ms2, host_ms, per_step


def run_training(torch, np, device, cfg, root: str):
    """Phase 7: car-config training on a synthetic KITTI train split.
    Returns (launches of the run, launches of one step, ms/step list,
    host leg ms/step, losses of the card step)."""
    import dataclasses
    import logging
    from sassd_tpu_torch import weights
    from sassd_tpu_torch.core import boxes as box_ops
    from sassd_tpu_torch.data import kitti, synthetic
    from sassd_tpu_torch.inference import to_device
    from sassd_tpu_torch.models.detector import Detector, parse_losses
    from sassd_tpu_torch.ops import warp
    from sassd_tpu_torch.train import checkpoint as ckpt, loop

    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, log_interval=1,
                                       checkpoint_interval=2),
        data=dataclasses.replace(cfg.data, num_workers=2))
    synthetic.write_synthetic_kitti(root, n_train=N_SCANS, n_val=0,
                                    seed=SEED + 3)
    data_root = os.path.join(root, "training")
    ds = kitti.KittiDataset(cfg, data_root,
                            os.path.join(root, "ImageSets", "train.txt"),
                            train=True)
    t = time.perf_counter()
    samples = [ds[i] for i in range(2)]
    host_ms = (time.perf_counter() - t) * 1e3
    batch = kitti.collate(samples)[0]
    print(f"training: batch 2 of scans {[m['sample_idx'] for m in kitti.collate(samples)[1]]}"
          f", GT boxes {batch['gt_valid'].sum(1).tolist()}, active voxels "
          f"{(batch['coords'][..., 0] >= 0).sum(1).tolist()}")
    anchors = torch.from_numpy(ds.anchors)

    # one step on the card against the same step on the CPU, in float32
    # and in float64 (the gradients' reference: backpropagating through
    # train-mode BatchNorm over 70k-cell maps amplifies float32 rounding)
    res = {}
    k3_in = []                  # the card step's K3 inputs and d_score
    k12_in = []                 # the card step's K12 inputs
    orig_k3, orig_k12 = warp.pswarp_score, box_ops.aux_targets

    def capture_k3(part_map, boxes, valid, *args):
        out = orig_k3(part_map, boxes, valid, *args)
        k3_in.append([part_map.detach().clone(), boxes.detach().clone(),
                      valid.clone(), args])
        out.register_hook(lambda g: k3_in[0].append(g.detach().clone()))
        return out

    def capture_k12(*args):
        k12_in.append([a.detach().clone() for a in args])
        return orig_k12(*args)
    for name, where, dtype in (("cpu64", "cpu", torch.float64),
                               ("cpu", "cpu", torch.float32),
                               ("card", device, torch.float32)):
        model = weights.seeded_detector(cfg, SEED, where).to(dtype)
        model.train()
        b = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in to_device(batch, where).items()}
        t = time.perf_counter()
        if name == "card":
            warp.pswarp_score, box_ops.aux_targets = capture_k3, capture_k12
        try:
            losses = model.forward_train(b, anchors.to(where, dtype))
        finally:
            warp.pswarp_score, box_ops.aux_targets = orig_k3, orig_k12
        parse_losses(losses).backward()
        if where != "cpu":
            torch.cuda.synchronize()
        res[name] = ({k: float(v.detach()) for k, v in losses.items()},
                     time.perf_counter() - t,
                     {k: p.grad.detach().cpu().double()
                      for k, p in model.named_parameters()})
    (l64, s64, g64), (cl, cs, cgr), (gl, _, ggr) = (
        res["cpu64"], res["cpu"], res["card"])
    for k, v in cl.items():
        print(f"training, card vs CPU: {k} {gl[k]:.7g} vs {v:.7g} "
              f"(float64 {l64[k]:.7g})")

    def gnorm(g, keys):
        return sum(float(torch.sum(g[k] ** 2)) for k in keys) ** 0.5

    def gerr(g, keys):
        return (sum(float(torch.sum((g[k] - g64[k]) ** 2)) for k in keys)
                ** 0.5 / max(gnorm(g64, keys), 1e-300))
    keys = list(g64)
    norm_err = abs(gnorm(ggr, keys) - gnorm(g64, keys)) / gnorm(g64, keys)
    print(f"training: grad norm card {gnorm(ggr, keys):.7g}, CPU "
          f"{gnorm(cgr, keys):.7g}, float64 CPU {gnorm(g64, keys):.7g} "
          f"(CPU steps {cs:.1f} s, {s64:.1f} s in float64)")
    mod_err = {}
    for mod in ("vxnet", "bevnet", "head", "pswarp", "aux"):
        mk = [k for k in keys if k.startswith(mod + ".")]
        mod_err[mod] = gerr(ggr, mk)
        print(f"training: {mod} gradients, rel L2 error against float64: "
              f"card {mod_err[mod]:.3g}, CPU {gerr(cgr, mk):.3g}")
    for k in ("guided_valid", "guided_pos"):
        if gl[k] != cl[k]:
            fail(f"training: {k} {gl[k]} on the card vs {cl[k]} on the CPU")
    bad = [k for k, v in cl.items() if "loss" in k
           and not abs(gl[k] - v) <= TRAIN_LOSS_RTOL * abs(v)]
    if (bad or norm_err > TRAIN_GNORM_RTOL
            or max(mod_err.values()) > TRAIN_GRAD_L2):
        fail(f"training: card and CPU disagree on {bad or 'the gradients'}")
    part_map, boxes3, valid, args, d_score = k3_in[0]
    k3b_check(torch, "phase 7's first train step", part_map, boxes3, valid,
              d_score.contiguous(), args)
    k12_check(torch, "phase 7's first train step", *k12_in[0])

    # the short run through train_model
    logged = []

    class Keep(logging.Handler):
        def emit(self, record):
            logged.append(record.getMessage())
    logger = logging.getLogger("sassd.chip_smoke")
    logger.setLevel(logging.INFO)
    logger.addHandler(Keep())
    work = os.path.join(root, "work")
    torch.cuda.synchronize()
    reset_launches()
    t = time.perf_counter()
    model, opt, steps = loop.train_model(cfg, ds, work,
                                         total_epochs=N_TRAIN_EPOCHS,
                                         device=device, logger=logger)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    launches = read_launches()
    print(f"training: train_model ran {steps} steps in {run_s:.1f} s; "
          f"launches {launches}")
    steps_logged = [m for m in logged if " step " in m]
    for m in steps_logged:
        print("  " + m)
    values = [float(kv.split("=")[1]) for m in steps_logged
              for kv in m.split() if "=" in kv]
    if steps != 2 * N_TRAIN_EPOCHS or opt.count != steps:
        fail(f"training: {steps} steps, {opt.count} updates applied")
    if len(steps_logged) != steps or not np.isfinite(values).all():
        fail("training: a logged loss or metric is not finite")
    if any("nonfinite_skips=0.0000" not in m for m in steps_logged):
        fail("training: an update was skipped as non-finite")
    path = ckpt.latest_checkpoint(work)
    restored = Detector(cfg).to(device)
    ckpt.restore(path, restored)
    same = all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 restored.state_dict().values()))
    print(f"training: checkpoints {[os.path.basename(p) for p in ckpt.list_checkpoints(work)]}; "
          f"{os.path.basename(path)} restores {'equal' if same else 'DIFFERENT'} "
          f"parameters and buffers")
    if not same:
        fail("training: the checkpoint does not restore the trained model")

    # timing: synchronised steps on one prepared batch, loader excluded
    step = loop.make_train_step(cfg, ds.anchors, opt, device)
    ms = train_step_ms(torch, step, model, batch)
    reset_launches()
    step(model, batch)
    torch.cuda.synchronize()
    per_step = read_launches()
    return launches, per_step, ms, host_ms, gl


def three_nn_diagnostic(torch, np, cfg, query, qvalid, coords, level):
    """The share of valid queries whose K15 3-NN set differs from a
    float64 direct-difference 3-NN over the level's cells, and the largest
    weight difference on the queries whose sets agree (no gate)."""
    from sassd_tpu_torch.ops import interpolate as itp
    centers = level_centers(np, cfg, coords, level).contiguous()
    valid = (coords[..., 0] >= 0).contiguous()
    feats = torch.zeros(coords.shape[:2] + (32,), device=coords.device)
    _, rows, w = itp.three_nn_fwd(query, centers, valid, feats)
    m = centers.shape[1]
    rows = rows.long().view(query.shape[0], -1, 3) % m
    w = w.view(query.shape[0], -1, 3).double()
    differ, n_q, w_err = 0, 0, 0.0
    k64 = centers.double()
    for b in range(query.shape[0]):
        for s in range(0, query.shape[1], 1024):
            ok = qvalid[b, s:s + 1024]
            u = query[b, s:s + 1024].double()
            d2 = ((u[:, None] - k64[b][None]) ** 2).sum(-1)
            d2 = torch.where(valid[b][None], d2, torch.inf)
            best, idx = torch.topk(d2, 3, dim=1, largest=False)
            w64 = 1.0 / (best + 1e-8)
            w64 = w64 / w64.sum(1, keepdim=True)
            got_i, order = torch.sort(rows[b, s:s + 1024], dim=1)
            ref_i, order64 = torch.sort(idx, dim=1)
            same = (got_i == ref_i).all(1) & ok
            differ += int(((got_i != ref_i).any(1) & ok).sum())
            n_q += int(ok.sum())
            dw = (torch.gather(w[b, s:s + 1024], 1, order)
                  - torch.gather(w64, 1, order64)).abs().max(1).values
            if same.any():
                w_err = max(w_err, float(dw[same].max()))
    return differ / max(n_q, 1), w_err, n_q


def run_multi_training(torch, np, device, root: str, host_step_ms):
    """Phase 8: three-class training on device plans (multi_config,
    host_plans=False) on a synthetic three-class split with its GT
    database. Returns the launches of the ring and exact train_model runs
    and of one batch-1 step of each."""
    import dataclasses
    import logging
    from sassd_tpu_torch import weights
    from sassd_tpu_torch.config import multi_config
    from sassd_tpu_torch.data import create_data, kitti, synthetic
    from sassd_tpu_torch.inference import to_device
    from sassd_tpu_torch.models.detector import parse_losses
    from sassd_tpu_torch.ops import sparse as sp
    from sassd_tpu_torch.train import loop, optim

    classes = ("Car", "Pedestrian", "Cyclist")
    synthetic.write_synthetic_kitti(root, n_train=N_SCANS, n_val=0,
                                    seed=SEED + 7, classes=classes)
    t = time.perf_counter()
    create_data.create_kitti_info_file(root, splits=("train",))
    db = create_data.create_groundtruth_database(root, "train",
                                                 list(classes))
    db_s = time.perf_counter() - t
    base = multi_config()

    def config(aux: str, host_plans: bool = False):
        return dataclasses.replace(
            base, model=dataclasses.replace(base.model, host_plans=host_plans,
                                            aux_interp=aux),
            train=dataclasses.replace(base.train, batch_size=1,
                                      log_interval=1,
                                      checkpoint_interval=N_MULTI_EPOCHS),
            data=dataclasses.replace(
                base.data, num_workers=2,
                db_info_path=os.path.join(root, "kitti_dbinfos_train.pkl")))
    cfg = config("ring")
    split = os.path.join(root, "ImageSets", "train.txt")
    data_root = os.path.join(root, "training")
    ds = kitti.KittiDataset(cfg, data_root, split, train=True)
    if ds.augmentor is None:
        fail("three-class training: the dataset built no augmentor")
    t = time.perf_counter()
    samples = [ds[i] for i in range(2)]
    leg_ms = (time.perf_counter() - t) * 1e3 / 2
    if any(k.startswith("plan_") for k in samples[0]):
        fail("three-class training: host plans built with host_plans=False")
    n_gt = [int(s["gt_valid"].sum()) for s in samples]
    labels = sorted({int(c) for s in samples
                     for c in s["gt_classes"][s["gt_valid"]]})
    print(f"three-class training: GT database of {len(ds)} scans "
          f"{ {k: len(v) for k, v in db.items()} } in {db_s:.1f} s; "
          f"augmented samples: GT boxes {n_gt}, classes {labels}, active "
          f"voxels {[int((s['coords'][:, 0] >= 0).sum()) for s in samples]}"
          f"; host leg (read + augment + voxelize + mask) {leg_ms:.1f} "
          f"ms/scan")

    # the device rulebook of sample 0 against the C++ train rulebook
    cfg_host = config("ring", host_plans=True)
    t = time.perf_counter()
    host_plans = kitti.build_host_plans(cfg_host, samples[0]["coords"],
                                        train=True)
    host_ms = (time.perf_counter() - t) * 1e3
    model = weights.seeded_detector(cfg, SEED, device)
    shapes = model.vxnet.level_shapes
    keys0 = sp.coords_to_keys(torch.from_numpy(
        samples[0]["coords"][None]).to(device), shapes[0])
    rb = sp.device_rulebook(keys0, shapes, cfg.caps.level_caps[1:],
                            train=True)
    torch.cuda.synchronize()
    diff = {k: int((v[0].cpu().numpy()
                    != host_plans[f"plan_{k}"].astype(np.int32)).sum())
            for k, v in rb.items()}
    if set(rb) != {k[5:] for k in host_plans} - {"subm3"} or any(
            diff.values()):
        fail(f"three-class training: device rulebook differs from the C++ "
             f"train rulebook: {diff}")
    dev_ms = cuda_ms(lambda: sp.device_rulebook(
        keys0, shapes, cfg.caps.level_caps[1:], train=True), iters=10)
    dev_exact_ms = cuda_ms(lambda: sp.device_rulebook(
        keys0, shapes, cfg.caps.level_caps[1:], train=True, aux=False),
        iters=10)
    print(f"three-class training: the device train rulebook ({len(rb)} "
          f"arrays) equals the C++ one bitwise; build time at batch 1: "
          f"card {dev_ms:.3f} ms (ring), {dev_exact_ms:.3f} ms (exact, no "
          f"aux plans), C++ host {host_ms:.1f} ms")

    # the exact 3-NN against float64 direct differences on level 1
    q = torch.from_numpy(samples[0]["voxels"][None]).to(device)
    n = torch.clamp(torch.from_numpy(samples[0]["num_points"][None]).to(
        device), min=1)[..., None].float()
    query = (q[..., :3].sum(-2) / n).contiguous()
    share, w_err, n_q = three_nn_diagnostic(
        torch, np, cfg, query, keys0 != sp.INVALID_KEY, rb["coords1"], 1)
    print(f"three-class training, diagnostic (no gate): K15's 3-NN set "
          f"differs from a float64 direct-difference 3-NN on "
          f"{100 * share:.4f}% of {n_q} queries (level 1, "
          f"{int((rb['coords1'][0, :, 0] >= 0).sum())} cells); largest "
          f"weight difference where the sets agree {w_err:.3g}")

    # one step on device plans against the same step on host plans
    anchors = torch.from_numpy(ds.anchors).to(device)
    res = {}
    for name, c, extra in (("device", cfg, {}), ("host", cfg_host,
                                                 host_plans)):
        m = weights.seeded_detector(c, SEED, device)
        m.train()
        b = to_device(kitti.collate([dict(samples[0], **extra)])[0], device)
        losses = m.forward_train(b, anchors)
        parse_losses(losses).backward()
        torch.cuda.synchronize()
        res[name] = ({k: float(v.detach()) for k, v in losses.items()},
                     {k: p.grad.detach().double()
                      for k, p in m.named_parameters()})
    (dl, dg), (hl, hg) = res["device"], res["host"]
    loss_err = max(abs(dl[k] - v) / max(abs(v), 1e-12)
                   for k, v in hl.items() if "loss" in k)
    keys = list(hg)
    norm_h = sum(float((hg[k] ** 2).sum()) for k in keys) ** 0.5
    norm_d = sum(float((dg[k] ** 2).sum()) for k in keys) ** 0.5
    mod_err = {}
    for mod in ("vxnet", "bevnet", "head", "pswarp", "aux"):
        mk = [k for k in keys if k.startswith(mod + ".")]
        ref = sum(float((hg[k] ** 2).sum()) for k in mk) ** 0.5
        mod_err[mod] = sum(float(((dg[k] - hg[k]) ** 2).sum())
                           for k in mk) ** 0.5 / max(ref, 1e-300)
    print(f"three-class training, device vs host plans on the card: "
          f"largest loss rel diff {loss_err:.3g} (tol {PLANS_LOSS_RTOL}); "
          f"grad norm {norm_d:.7g} vs {norm_h:.7g} (rel diff "
          f"{abs(norm_d - norm_h) / norm_h:.3g}, tol {PLANS_GNORM_RTOL}); "
          f"module rel L2 "
          f"{ {k: float(f'{v:.3g}') for k, v in mod_err.items()} } (tol "
          f"{PLANS_GRAD_L2}); losses {dict(sorted(dl.items()))}")
    for k in ("guided_valid", "guided_pos"):
        if dl[k] != hl[k]:
            fail(f"three-class training: {k} {dl[k]} on device plans vs "
                 f"{hl[k]} on host plans")
    if (loss_err > PLANS_LOSS_RTOL
            or abs(norm_d - norm_h) > PLANS_GNORM_RTOL * norm_h
            or max(mod_err.values()) > PLANS_GRAD_L2):
        fail("three-class training: device and host plans disagree")

    # train_model, ring then exact, and the step times
    logger = logging.getLogger("sassd.chip_smoke.multi")
    logger.setLevel(logging.INFO)
    runs, per_step, times = {}, {}, {}
    batch1 = kitti.collate(samples[:1])[0]
    batch2 = kitti.collate(samples)[0]
    for aux in ("ring", "exact"):
        c = config(aux)
        d = kitti.KittiDataset(c, data_root, split, train=True)
        logged = []

        class Keep(logging.Handler):
            def emit(self, record):
                logged.append(record.getMessage())
        handler = Keep()
        logger.addHandler(handler)
        torch.cuda.synchronize()
        reset_launches()
        t = time.perf_counter()
        model, opt, steps = loop.train_model(
            c, d, os.path.join(root, f"work_{aux}"),
            total_epochs=N_MULTI_EPOCHS, device=device, logger=logger)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        runs[aux] = read_launches()
        logger.removeHandler(handler)
        steps_logged = [m for m in logged if " step " in m]
        values = [float(kv.split("=")[1]) for m in steps_logged
                  for kv in m.split() if "=" in kv]
        print(f"three-class training, {aux} aux: train_model ran {steps} "
              f"steps in {run_s:.1f} s; launches {runs[aux]}")
        for m in steps_logged:
            print("  " + m)
        if steps != N_MULTI_EPOCHS * N_SCANS or opt.count != steps:
            fail(f"three-class training, {aux}: {steps} steps, "
                 f"{opt.count} updates applied")
        if len(steps_logged) != steps or not np.isfinite(values).all():
            fail(f"three-class training, {aux}: a logged loss or metric "
                 f"is not finite")
        if any("nonfinite_skips=0.0000" not in m for m in steps_logged):
            fail(f"three-class training, {aux}: an update was skipped")
        step = loop.make_train_step(c, ds.anchors, optim.make_optimizer(
            model, c.train, 1000), device)
        times[aux] = (train_step_ms(torch, step, model, batch1),
                      train_step_ms(torch, step, model, batch2))
        reset_launches()
        step(model, batch1)
        torch.cuda.synchronize()
        per_step[aux] = read_launches()
        check_once(sp, per_step[aux], f"three-class training, {aux} aux",
                   "K13", 1)
        check_once(sp, per_step[aux], f"three-class training, {aux} aux",
                   "K14", 1 if aux == "ring" else 0)
    host_model = weights.seeded_detector(cfg_host, SEED, device)
    host_step = loop.make_train_step(cfg_host, ds.anchors,
                                     optim.make_optimizer(
                                         host_model, cfg_host.train, 1000),
                                     device)
    host_b1 = train_step_ms(torch, host_step, host_model, kitti.collate(
        [dict(samples[0], **host_plans)])[0])
    for aux in ("ring", "exact"):
        b1, b2 = times[aux]
        print(f"three-class training step on device plans, {aux} aux: "
              f"batch 1 {', '.join(f'{m:.2f}' for m in b1)} ms/step; batch "
              f"2 {', '.join(f'{m:.2f}' for m in b2)} ms/step (host clock, "
              f"synchronised, loader excluded)")
    print(f"three-class training step on host plans, ring aux, batch 1: "
          f"{', '.join(f'{m:.2f}' for m in host_b1)} ms/step; the car "
          f"config's phase-7 host-plans step at batch 2: "
          f"{', '.join(f'{m:.2f}' for m in host_step_ms)} ms/step")
    return runs, per_step


def level_counts(sp, keys0, plans) -> list:
    """Active rows of each level [L0, L1, L2, L3], each a list over the
    rulebook's rows."""
    return [(keys0 != sp.INVALID_KEY).sum(1).tolist()] + [
        (plans[f"coords{lvl}"][..., 0] >= 0).sum(1).tolist()
        for lvl in (1, 2, 3)]


def rulebook_counts(torch, device, cfg, spec, sample_batch):
    """Level counts of a batch's replicated device rulebook and of its
    banded one, and the banded level-0 overflow [S, B]."""
    from sassd_tpu_torch.models import backbone
    from sassd_tpu_torch.ops import sparse as sp
    from sassd_tpu_torch.parallel import sparse_spatial as ss
    coords = torch.from_numpy(sample_batch["coords"]).to(device)
    shapes = backbone.level_shapes(cfg.sparse_shape)
    keys0 = sp.coords_to_keys(coords, shapes[0])
    rep = level_counts(sp, keys0, sp.device_rulebook(
        keys0, shapes, cfg.caps.level_caps[1:]))
    bc, _, over = ss.partition(coords, torch.zeros(
        coords.shape[:2] + (4,), device=device), spec)
    bshapes = backbone.level_shapes(ss.band_shape(cfg, spec))
    keys0 = sp.coords_to_keys(bc.reshape(-1, bc.shape[2], 3), bshapes[0])
    band = level_counts(sp, keys0, sp.device_rulebook(
        keys0, bshapes, spec.caps[1:],
        y_top=ss.y_top_rows(cfg, spec, coords.shape[0], device)))
    return rep, band, over.tolist()


def check_banded_kernels(torch, np, device, cfg, spec, batch, timing):
    """Phase 9, the kernels of the banded stage at full long-range width
    on the comparison batch (2 scans, 8 band rows): K16 (band partition)
    bitwise against its plain version, also with a fifth of the level-0
    cap, which drops members; K7 with each row's y limit, levels 1-3 of the band
    rulebook, bitwise; K11 with per-row grid origins at levels 1-3: rows,
    weights and output bitwise, its backward within TRAIN_GRAD_RTOL.
    Timed: K16 and K7 (L0 -> L1) on the timing scan (batch 1, 4 band
    rows), K7 replicated (L0 -> L1 of the timing scan, bitwise), K11 at
    batch 2."""
    from sassd_tpu_torch.models import backbone
    from sassd_tpu_torch.ops import sparse as sp
    from sassd_tpu_torch.ops.cuda import same_bits
    from sassd_tpu_torch.parallel import sparse_spatial as ss

    def inputs(b):
        coords = torch.from_numpy(b["coords"]).to(device)
        vfe = backbone.vfe_mean(torch.from_numpy(b["voxels"]).to(device),
                                torch.from_numpy(b["num_points"]).to(device))
        return coords, vfe
    rng = np.random.default_rng(SEED + 9)
    coords, vfe = inputs(batch)
    tc, tv = inputs(timing)
    nb = coords.shape[0]
    bshapes = backbone.level_shapes(ss.band_shape(cfg, spec))
    rows = []

    # K16
    err16, over16 = 0.0, {}
    forced = f"cap0 {spec.caps[0] // 5}"
    for what, sp_ in (("caps", spec),
                      (forced, spec._replace(
                          caps=(spec.caps[0] // 5,) + spec.caps[1:]))):
        got = ss.partition(coords, vfe, sp_)
        ref = ss.partition_plain(coords, vfe, sp_)
        same = all(same_bits(g, r) for g, r in zip(got, ref))
        err16 = max([err16] + [float((g.double() - r.double()).abs().max())
                               for g, r in zip(got, ref)])
        over16[what] = got[2].tolist()
        print(f"K16 band_partition {tuple(coords.shape)} -> "
              f"{tuple(got[0].shape)} ({what}): "
              f"{'bitwise equal to' if same else 'DIFFERS from'} plain; "
              f"overflow [S, B] {over16[what]}")
        if not same:
            fail(f"K16 differs from its plain version ({what})")
    if not any(v for r in over16[forced] for v in r):
        fail("K16: the forced-overflow case dropped no member")
    t16 = timed(lambda: ss.partition(tc, tv, spec))
    plain_ms = cuda_ms(lambda: ss.partition_plain(tc, tv, spec))
    print(f"  K16 batch 1 (timing scan): kernel {fmt_timed(t16)}, plain "
          f"{plain_ms:.4f} ms; "
          f"{fmt_split(lambda: ss.partition(tc, tv, spec))}")
    m0, f = tc.shape[1], tv.shape[2]
    n_tv = int((tc[..., 0] >= 0).sum())
    rows.append(dict(name="K16 band_partition", route="cuda",
                     source="sassd_tpu_torch/csrc/band_partition.cu",
                     replaces="sassd_tpu/parallel/sparse_spatial.py:89",
                     max_abs_err=err16, **t16, plain_ms=plain_ms,
                     library_ms=None,
                     library_what="none: a boolean-mask compaction is one "
                                  "call a band and field, without the "
                                  "padding or the cap",
                     at=f"batch 1, the timing scan ({n_tv} voxels), "
                        f"{spec.s} bands, cap0 {spec.caps[0]}",
                     # coords and rows in once; the band arrays and the
                     # overflow out
                     **bound(m0 * (12 + 4 * f)
                             + spec.s * spec.caps[0] * (12 + 4 * f)
                             + spec.s * 4, 0)))

    # K7 with the y limit, levels 1-3 of the comparison batch's bands
    bc, bv, over = ss.partition(coords, vfe, spec)
    cell0 = bc.reshape(spec.s * nb, -1, 3)
    keys = keys0 = sp.coords_to_keys(cell0, bshapes[0])
    y_top = ss.y_top_rows(cfg, spec, nb, device)
    err7, clipped = 0.0, []
    for lvl in (1, 2, 3):
        args = (bshapes[lvl - 1], spec.caps[lvl], y_top >> lvl)
        out = sp.downsample_keys(keys, *args)
        ref = sp.downsample_keys_plain(keys, *args)
        err7 = max(err7, float((out.long() - ref.long()).abs().max()))
        free = sp.downsample_keys(keys, *args[:2])
        clipped.append(int((out != free).any(1).sum()))
        keys = out
    print(f"K7 downsample with y_top, {spec.s * nb} band rows, levels 1-3: "
          f"max|kernel-plain| {err7:g}; rows the limit changed per level "
          f"{clipped}")
    if err7:
        fail("K7 with a y limit differs from its plain version")
    tkeys = sp.coords_to_keys(ss.partition(tc, tv, spec)[0].reshape(
        spec.s, -1, 3), bshapes[0])
    ty = ss.y_top_rows(cfg, spec, 1, device) >> 1
    rows.append(k7_row(torch, sp, tkeys, bshapes[0], spec.caps[1], err7,
                       "K7' downsample_y_top",
                       f"L0 -> L1 of the timing scan's {spec.s} band rows",
                       ty))

    # K7 replicated at long range: L0 -> L1 of the timing scan, batch 1
    rshapes = backbone.level_shapes(cfg.sparse_shape)
    rkeys = sp.coords_to_keys(tc, rshapes[0])
    cap1 = cfg.caps.level_caps[1]
    got = sp.downsample_keys(rkeys, rshapes[0], cap1)
    ref = sp.downsample_keys_plain(rkeys, rshapes[0], cap1)
    err_lr = float((got.long() - ref.long()).abs().max())
    n0 = int((rkeys != sp.INVALID_KEY).sum())
    n1 = int((ref != sp.INVALID_KEY).sum())
    print(f"K7 downsample, long range replicated, L0 -> L1 of the timing "
          f"scan ({n0} voxels -> {n1} rows, cap {cap1}): max|kernel-plain| "
          f"{err_lr:g}")
    if err_lr:
        fail("K7 differs from its plain version at long range")
    rows.append(k7_row(torch, sp, rkeys, rshapes[0], cap1, err_lr,
                       "K7 downsample_long_range",
                       "L0 -> L1 of the long-range timing scan, replicated, "
                       "batch 1"))

    # K11 with per-row origins on the band train rulebook's aux plans
    plans = sp.device_rulebook(keys0, bshapes, spec.caps[1:], train=True,
                               y_top=y_top)
    # K13 at the band rows: the levels' keys and maps of the band rulebook
    bkeys = [keys0] + [sp.coords_to_keys(plans[f"coords{lvl}"], bshapes[lvl])
                       for lvl in (1, 2, 3)]
    bmaps = [sp.build_index_map(k, s) for k, s in zip(bkeys[1:], bshapes[1:])]
    row13 = k13_check(torch, f"banded, batch 2 ({spec.s * nb} band rows), "
                             f"levels 1-3 in one call", bkeys, bmaps, bshapes,
                      [plans[f"stride{lvl}"] for lvl in (1, 2, 3)])
    row13["name"] = "K13 stride_plans_T, banded"
    rows.append(row13)
    del bmaps
    query = bv.reshape(spec.s * nb, -1, bv.shape[-1])[..., :3].contiguous()
    origins = ss.band_origins(cfg, spec, nb, device)
    k11 = {}
    for level, c in ((1, 32), (2, 64), (3, 64)):
        vs = (np.asarray(cfg.voxel.voxel_size, np.float32)
              * 2 ** level).tolist()
        m = spec.caps[level]
        feats = torch.from_numpy(rng.normal(size=(spec.s * nb, m, c)).astype(
            np.float32)).to(device)
        cot = torch.from_numpy(rng.normal(size=query.shape[:2] + (c,)).astype(
            np.float32)).to(device)
        k11[level] = ring_interp_level(torch, " with per-row origins", query,
                                       cell0, level, feats,
                                       plans[f"aux{level}"], vs, origins, cot)
    rows.append(ring_interp_row(
        k11, "K11' ring_interp_origins",
        "sassd_tpu/parallel/sparse_spatial.py:143",
        f"batch 2 ({spec.s * nb} band rows), levels 1-3"))
    return rows


def long_range_inputs(np, root: str):
    """Phase 9's configs and inputs: the long-range config banded over 4
    y-bands (cfg_b) and replicated on device plans (cfg_r), the band spec,
    the 4-scan synthetic train split written under root, its first two
    samples and their batch, and the timing scan's batch."""
    import dataclasses
    from sassd_tpu_torch.config import ParallelConfig, long_range_config
    from sassd_tpu_torch.data import kitti, synthetic
    from sassd_tpu_torch.parallel import sparse_spatial as ss

    base = long_range_config()
    cfg_b = dataclasses.replace(
        base, parallel=ParallelConfig(strategy="banded", spatial=4),
        train=dataclasses.replace(base.train, log_interval=1,
                                  checkpoint_interval=1),
        data=dataclasses.replace(base.data, num_workers=2))
    cfg_r = dataclasses.replace(cfg_b, parallel=ParallelConfig(),
                                model=dataclasses.replace(
                                    base.model, host_plans=False))
    synthetic.write_synthetic_kitti(
        root, n_train=N_SCANS, n_val=0, seed=SEED + 9,
        point_cloud_range=cfg_b.voxel.point_cloud_range,
        n_ground=LR_GROUND)
    ds = kitti.KittiDataset(cfg_b, os.path.join(root, "training"),
                            os.path.join(root, "ImageSets", "train.txt"),
                            train=True)
    samples = [ds[i] for i in range(2)]
    if any(k.startswith("plan_") for k in samples[0]):
        fail("long range: host plans built for the banded config")
    timing = kitti.prepare_scan(cfg_b, synthetic.long_range_scene(
        np.random.default_rng(SEED + 10))[0], ds.anchors_bv)
    return dict(cfg_b=cfg_b, cfg_r=cfg_r, spec=ss.config_band_spec(cfg_b),
                ds=ds, samples=samples, batch=kitti.collate(samples)[0],
                t_batch=kitti.collate([timing])[0])


def run_long_range(torch, np, device, root: str):
    """Phase 9: the long-range config, banded over 4 y-bands against
    replicated (device plans), at full width. Returns (kernel rows,
    launches of banded inference, of replicated inference and of the
    banded train_model run, launches of one banded train step)."""
    import logging
    from sassd_tpu_torch.data import kitti
    from sassd_tpu_torch.inference import make_test_step, to_device
    from sassd_tpu_torch.models.detector import parse_losses
    from sassd_tpu_torch.ops import sparse as sp
    from sassd_tpu_torch.train import loop, optim
    from sassd_tpu_torch.weights import seeded_detector

    lr = long_range_inputs(np, root)
    cfg_b, cfg_r, spec, ds, samples, batch, t_batch = (
        lr[k] for k in ("cfg_b", "cfg_r", "spec", "ds", "samples", "batch",
                        "t_batch"))
    rows = check_banded_kernels(torch, np, device, cfg_b, spec, batch,
                                t_batch)
    for what, b in (("comparison scans", batch), ("timing scan", t_batch)):
        rep, band, over = rulebook_counts(torch, device, cfg_b, spec, b)
        print(f"long range, {what}: active rows per level, replicated "
              f"{rep} (caps {list(cfg_b.caps.level_caps)}); banded, "
              f"band-major rows {band} (caps {list(spec.caps)}); level-0 "
              f"band overflow {over}")
        if what == "comparison scans":
            full = [lv for lv, (n, cap) in enumerate(zip(rep, cfg_b.caps
                                                         .level_caps))
                    if max(n) >= cap]
            full += [lv for lv, (n, cap) in enumerate(zip(band, spec.caps))
                     if max(n) >= cap]
            if full or any(v for r in over for v in r):
                fail(f"long range: a comparison scan fills a cap (levels "
                     f"{full}) or overflows a band")

    model_b = seeded_detector(cfg_b, SEED, device)
    model_r = seeded_detector(cfg_r, SEED, device)
    model_r.load_state_dict(model_b.state_dict())
    anchors = torch.from_numpy(ds.anchors).to(device)

    # forward_test, banded then replicated, each scan at batch 1
    b1 = [kitti.collate([s])[0] for s in samples]
    steps = {"banded": (make_test_step(cfg_b, ds.anchors, device), model_b),
             "replicated": (make_test_step(cfg_r, ds.anchors, device),
                            model_r)}
    dets, launches = {}, {}
    for what, (step, model) in steps.items():
        step(model, b1[0])                                # warm-up
        torch.cuda.synchronize()
        reset_launches()
        dets[what] = [{k: v.cpu().numpy() for k, v in step(model, b).items()}
                      for b in b1]
        torch.cuda.synchronize()
        launches[what] = read_launches()
        print(f"long range, {what} inference: launches {launches[what]}")
    counts = [match_detections(dets["banded"][i], dets["replicated"][i],
                               f"long range, scan {i}: banded vs replicated")
              for i in range(len(b1))]
    print(f"long range: banded detections match replicated ones on both "
          f"scans ({counts} detections; boxes {DET_BOX_ATOL}, scores "
          f"{DET_SCORE_ATOL})")

    # one forward_train + backward, banded and replicated, same weights.
    # The guided candidates are a top-k over scores, so a near-tie may
    # flip between two float32 runs and change the PSWarp loss's
    # gradients; the gradients are held to the gates with that loss left
    # out (everything upstream of the top-k), the PSWarp module's own
    # gradients with it. A replicated step on inputs perturbed by one
    # float32 ulp shows how far float32 rounding alone moves them.
    res = {}
    for what, cfg in (("banded", cfg_b), ("replicated", cfg_r),
                      ("perturbed", cfg_r)):
        model = seeded_detector(cfg, SEED, device)
        model.load_state_dict(model_b.state_dict())
        model.train()
        before = {k: v.clone() for k, v in model.named_buffers()
                  if k.rsplit(".", 1)[-1] in ("mean", "var")}
        b = to_device(batch, device)
        if what == "perturbed":
            b["voxels"] = b["voxels"] * (1.0 + 2.0 ** -23)
        losses = model.forward_train(b, anchors)
        params = dict(model.named_parameters())
        upstream = sum(v for k, v in losses.items()
                       if "loss" in k and k != "loss_cls")
        g_up = torch.autograd.grad(upstream, list(params.values()),
                                   retain_graph=True, allow_unused=True)
        parse_losses(losses).backward()
        torch.cuda.synchronize()
        res[what] = dict(
            losses={k: float(v.detach()) for k, v in losses.items()},
            upstream={k: (g if g is not None else torch.zeros_like(p))
                      .detach().double()
                      for (k, p), g in zip(params.items(), g_up)},
            full={k: p.grad.detach().double() for k, p in params.items()},
            bn={k: (v - before[k]).double()
                for k, v in model.named_buffers() if k in before})

    def grad_diff(a, b, kind):
        """(relative norm difference, module rel L2 errors) of b vs a."""
        ga, gb = res[a][kind], res[b][kind]
        norm_a = sum(float((g ** 2).sum()) for g in ga.values()) ** 0.5
        norm_b = sum(float((g ** 2).sum()) for g in gb.values()) ** 0.5
        mods = {}
        for mod in ("vxnet", "bevnet", "head", "pswarp", "aux"):
            mk = [k for k in ga if k.startswith(mod + ".")]
            ref = sum(float((ga[k] ** 2).sum()) for k in mk) ** 0.5
            if ref > 0:
                mods[mod] = sum(float(((gb[k] - ga[k]) ** 2).sum())
                                for k in mk) ** 0.5 / ref
        return abs(norm_b - norm_a) / norm_a, mods

    def fmt(d):
        return {k: float(f"{v:.3g}") for k, v in d.items()}
    bl, rl = res["banded"]["losses"], res["replicated"]["losses"]
    if bl.get("band_overflow") != 0.0:
        fail(f"long range: band_overflow {bl.get('band_overflow')}")
    bad = [k for k, v in rl.items() if "loss" in k
           and not abs(bl[k] - v) <= TRAIN_LOSS_RTOL * abs(v)]
    up_norm, up_mods = grad_diff("replicated", "banded", "upstream")
    full_norm, full_mods = grad_diff("replicated", "banded", "full")
    noise_norm, noise_mods = grad_diff("replicated", "perturbed", "full")
    bs, rs = res["banded"]["bn"], res["replicated"]["bn"]
    bn_err = max(float((bs[k] - rs[k]).abs().max()
                       / rs[k].abs().max().clamp(min=1e-12)) for k in rs)
    print(f"long range, one train step at batch 2, banded vs replicated: "
          f"losses {dict(sorted(bl.items()))} vs {dict(sorted(rl.items()))}"
          f"; gradients without the PSWarp loss: norm rel diff "
          f"{up_norm:.3g}, module rel L2 {fmt(up_mods)} (tol "
          f"{TRAIN_GNORM_RTOL}, {TRAIN_GRAD_L2}); full objective: norm "
          f"{full_norm:.3g}, modules {fmt(full_mods)}; a replicated step on "
          f"inputs one ulp off: norm {noise_norm:.3g}, modules "
          f"{fmt(noise_mods)}; largest BN running-stat update difference "
          f"{bn_err:.3g} of its buffer's largest update")
    if (bad or up_norm > TRAIN_GNORM_RTOL
            or max(up_mods.values()) > TRAIN_GRAD_L2
            or full_mods["pswarp"] > TRAIN_GRAD_L2
            or bn_err > BN_UPDATE_RTOL):
        fail(f"long range: banded and replicated train steps disagree "
             f"({bad or 'gradients or BN statistics'})")

    # train_model of the banded config: 2 steps at batch 2 (8 band rows)
    logged = []

    class Keep(logging.Handler):
        def emit(self, record):
            logged.append(record.getMessage())
    logger = logging.getLogger("sassd.chip_smoke.long_range")
    logger.setLevel(logging.INFO)
    logger.addHandler(Keep())
    torch.cuda.synchronize()
    reset_launches()
    t = time.perf_counter()
    model_t, opt, n_steps = loop.train_model(
        cfg_b, ds, os.path.join(root, "work"), total_epochs=1,
        device=device, logger=logger)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    launches["training"] = read_launches()
    lines = [m for m in logged if " step " in m]
    print(f"long range, banded train_model ran {n_steps} steps in "
          f"{run_s:.1f} s; launches {launches['training']}")
    for m in lines:
        print("  " + m)
    values = [float(kv.split("=")[1]) for m in lines for kv in m.split()
              if "=" in kv]
    if n_steps != N_SCANS // cfg_b.train.batch_size or opt.count != n_steps:
        fail(f"long range: {n_steps} steps, {opt.count} updates applied")
    if len(lines) != n_steps or not np.isfinite(values).all():
        fail("long range: a logged loss or metric is not finite")
    if any("band_overflow=0.0000" not in m
           or "nonfinite_skips=0.0000" not in m for m in lines):
        fail("long range: a step overflowed a band or skipped its update")

    # timings: ms/scan at batch 1 on the timing scan, in turns, and the
    # train step at batch 2, banded and replicated
    ms = {"banded": [], "replicated": []}
    for what in ("banded", "replicated", "replicated", "banded"):
        step, model = steps[what]
        step(model, t_batch)
        torch.cuda.synchronize()
        for _ in range(2):
            t = time.perf_counter()
            step(model, t_batch)
            torch.cuda.synchronize()
            ms[what].append((time.perf_counter() - t) * 1e3)
    train_ms = {}
    for what, cfg, model in (("banded", cfg_b, model_t),
                             ("replicated", cfg_r, model_r)):
        step = loop.make_train_step(cfg, ds.anchors, optim.make_optimizer(
            model, cfg.train, 1000), device)
        train_ms[what] = train_step_ms(torch, step, model, batch)
        if what == "banded":
            reset_launches()
            step(model, batch)
            torch.cuda.synchronize()
            per_step = read_launches()
            for kid in ("K13", "K14"):
                check_once(sp, per_step, "long range, banded training", kid,
                           1)
    return rows, launches, per_step, ms, train_ms


TRAIN_PHASE_IDS = "K1 K3 K3b K4 K5 K5b K10 K11 K12"
SERVE_PHASE_IDS = "K1 K2 K3 K4 K5 K6 K7 K8 K9"


def kernel_symbols() -> dict:
    """Kernel id -> the launch-count symbols of its entry points."""
    from sassd_tpu_torch import serve
    from sassd_tpu_torch.core import boxes
    from sassd_tpu_torch.ops import interpolate as itp
    from sassd_tpu_torch.ops import sparse as sp
    from sassd_tpu_torch.ops import voxelize as vox
    from sassd_tpu_torch.ops import warp
    from sassd_tpu_torch.parallel import sparse_spatial as ss
    return {"K1": ("sassd_riou_overlap",), "K2": ("sassd_nms_keep",),
            **warp.KERNEL_SYMBOLS, **sp.KERNEL_SYMBOLS,
            **vox.KERNEL_SYMBOLS, **serve.KERNEL_SYMBOLS,
            **itp.KERNEL_SYMBOLS, **boxes.KERNEL_SYMBOLS,
            **ss.KERNEL_SYMBOLS, "K7'": sp.KERNEL_SYMBOLS["K7"],
            "K11'": itp.KERNEL_SYMBOLS["K11"]}


def check_launched(launches: dict, ids: str, what: str) -> None:
    """Fail unless every kernel of `ids` launched in `launches`."""
    symbols = kernel_symbols()
    idle = [s for k in ids.split() for s in symbols[k] if launches[s] == 0]
    if idle:
        fail(f"{what}: a kernel of the path was not launched: {idle}")


def write_dp_splits(root: str) -> None:
    """Phase 10's data under root: phase 7's 4-scan train split (its seed)
    and phase 6's 4-scan val split."""
    from sassd_tpu_torch.data import synthetic
    synthetic.write_synthetic_kitti(os.path.join(root, "train"),
                                    n_train=N_SCANS, n_val=0, seed=SEED + 3)
    synthetic.write_synthetic_kitti(os.path.join(root, "val"), n_train=0,
                                    n_val=N_SCANS, seed=SEED)


def dp_data(cfg, root: str):
    """Phase 10's inputs from the splits under root. Returns (train
    dataset, val dataset, the points-serving config, the train samples of
    the DP_STEPS global batches of 2, the label directory)."""
    import dataclasses
    from sassd_tpu_torch.data import kitti
    tr, va = os.path.join(root, "train"), os.path.join(root, "val")
    train_ds = kitti.KittiDataset(cfg, os.path.join(tr, "training"),
                                  os.path.join(tr, "ImageSets", "train.txt"),
                                  train=True)
    cfg_pts = dataclasses.replace(cfg, test=dataclasses.replace(
        cfg.test, device_input="points"))
    val_ds = kitti.KittiDataset(cfg, os.path.join(va, "training"),
                                os.path.join(va, "ImageSets", "val.txt"))
    samples = [train_ds[i] for i in range(2 * DP_STEPS)]
    return (train_ds, val_ds, cfg_pts, samples,
            os.path.join(va, "training", "label_2"))


def dp_steps(torch, device, cfg, anchors, batches):
    """DP_STEPS train steps from phase 7's start weights (seed SEED), one
    per batch, with the launch counters reset just before and read just
    after. Returns (metrics per step as floats, step 1's .grad (CPU), the
    BatchNorm buffers after step 1's forward, the final state dict (CPU),
    launches)."""
    from sassd_tpu_torch.train import loop, optim
    from sassd_tpu_torch.weights import seeded_detector
    model = seeded_detector(cfg, SEED, device)
    opt = optim.make_optimizer(model, cfg.train, DP_STEPS)
    step = loop.make_train_step(cfg, anchors, opt, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    reset_launches()
    metrics, grads, bn = [], None, None
    for b in batches:
        m = step(model, b)
        metrics.append({k: float(v) for k, v in m.items()})
        if grads is None:
            grads = {k: p.grad.detach().cpu().clone()
                     for k, p in model.named_parameters()}
            bn = {k: v.detach().cpu().clone()
                  for k, v in model.named_buffers()
                  if k.rsplit(".", 1)[-1] in ("mean", "var")}
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = read_launches()
    state = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    return metrics, grads, bn, state, launches


def max_abs_diff(torch, a: dict, b: dict) -> float:
    """Largest |a - b| over the entries of two dicts of tensors or
    floats (0.0 when every entry is bitwise equal)."""
    out = 0.0
    for k in a:
        x, y = a[k], b[k]
        if torch.is_tensor(x):
            if not torch.equal(x, y):
                out = max(out, float((x.double() - y.double()).abs().max()))
        elif x != y:
            out = max(out, abs(x - y))
    return out


def module_l2(torch, got: dict, ref: dict) -> dict:
    """Each module's gradients' relative L2 distance from `ref`."""
    out = {}
    for mod in ("vxnet", "bevnet", "head", "pswarp", "aux"):
        keys = [k for k in ref if k.startswith(mod + ".")]
        num = sum(float(torch.sum((got[k].double() - ref[k].double()) ** 2))
                  for k in keys)
        den = sum(float(torch.sum(ref[k].double() ** 2)) for k in keys)
        out[mod] = (num / max(den, 1e-300)) ** 0.5
    return out


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_dp_world_one(torch, device, cfg, anchors, batches):
    """Phase 10a: the steps with no group, in a one-rank group of the
    device's backend (NCCL on the card), and with no group again. Returns
    the three runs (dp_steps' tuples) and the coalesced reductions' in ==
    out flags of the group's run."""
    from sassd_tpu_torch.parallel import dist
    ref = dp_steps(torch, device, cfg, anchors, batches)
    copies = []
    reduce = dist.all_reduce_coalesced

    def keep(tensors):
        before = [t.clone() for t in tensors]
        reduce(tensors)
        copies.append(all(torch.equal(a, b)
                          for a, b in zip(before, tensors)))
    for attempt in range(3):
        try:
            dist.initialize(f"localhost:{free_port()}", 1, 0, device=device,
                            timeout_s=DP_GROUP_TIMEOUT_S)
            break
        except RuntimeError as e:
            if attempt == 2 or not any(s in str(e).lower()
                                       for s in ADDR_IN_USE):
                raise
    dist.all_reduce_coalesced = keep
    try:
        backend = torch.distributed.get_backend()
        group = dp_steps(torch, device, cfg, anchors, batches)
    finally:
        dist.all_reduce_coalesced = reduce
        dist.shutdown()
    again = dp_steps(torch, device, cfg, anchors, batches)
    return ref, group, again, copies, backend


def dp_worker(argv) -> int:
    """One rank of phase 10b/10c, started by run_dp_ranks: argv = rank,
    world, port, job file (a torch.save of the config, the device and the
    paths). Joins the gloo group, runs the steps on its slice of each
    global batch and evaluate at batch 1, and saves what the parent
    checks."""
    rank, world, port, job_path = (int(argv[0]), int(argv[1]),
                                   int(argv[2]), argv[3])
    sys.path.insert(0, HERE)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sassd_tpu_torch import inference
    from sassd_tpu_torch.data import kitti
    from sassd_tpu_torch.parallel import dist
    from sassd_tpu_torch.weights import seeded_detector
    job = torch.load(job_path, weights_only=False)
    device = torch.device(job["device"])
    cfg = job["cfg"]
    dist.initialize(f"localhost:{port}", world, rank, backend="gloo",
                    device=device, timeout_s=DP_GROUP_TIMEOUT_S)
    train_ds, val_ds, cfg_pts, samples, label_dir = dp_data(cfg, job["root"])
    local = [kitti.collate([samples[world * t + rank]])[0]
             for t in range(DP_STEPS)]
    metrics, grads, bn, state, launches = dp_steps(
        torch, device, cfg, train_ds.anchors, local)

    gathered = []
    gather = dist.gather_objects

    def keep(obj, *args, **kw):
        parts = gather(obj, *args, **kw)
        gathered.append(parts)
        return parts
    dist.gather_objects = keep
    model = seeded_detector(cfg, SEED, device)
    reset_launches()
    results, text = inference.evaluate(
        cfg_pts, val_ds, model, label_dir, 1, device,
        exchange_dir=os.path.join(job["out"], "exchange"))
    if device.type == "cuda":
        torch.cuda.synchronize()
    torch.save(dict(metrics=metrics, grads=grads, bn=bn, state=state,
                    launches=launches, eval_launches=read_launches(),
                    results=results, text=text, parts=gathered[0]),
               os.path.join(job["out"], f"rank{rank}.pt"))
    dist.barrier("dp_worker_done")
    dist.shutdown()
    return 0


def run_dp_ranks(torch, device, cfg, root: str, world: int = 2):
    """Phase 10b/10c: `world` rank subprocesses of this script on
    `device`, each with a time limit (all killed at the first one over
    it). Returns their saved results, rank order."""
    out = os.path.join(root, "ranks")
    os.makedirs(out, exist_ok=True)
    job = os.path.join(out, "job.pt")
    torch.save(dict(cfg=cfg, device=str(device), root=root, out=out), job)
    for attempt in range(3):
        port = free_port()
        logs = [open(os.path.join(out, f"rank{r}_try{attempt}.log"), "w+")
                for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp-worker",
             str(r), str(world), str(port), job],
            stdout=logs[r], stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        deadline = time.time() + DP_WORKER_TIMEOUT_S
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.time(), 1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            over = [p for p in procs if p.poll() is None]
            for p in over:
                p.kill()
                p.wait()
        text = []
        for f in logs:
            f.seek(0)
            text.append(f.read())
            f.close()
        if over:
            fail(f"data-parallel: a rank outlived {DP_WORKER_TIMEOUT_S} s:\n"
                 + "\n".join(t[-3000:] for t in text))
        if all(p.returncode == 0 for p in procs):
            return [torch.load(os.path.join(out, f"rank{r}.pt"),
                               weights_only=False) for r in range(world)]
        taken = any(s in t.lower() for t in text for s in ADDR_IN_USE)
        if not taken or attempt == 2:
            bad = next(t for p, t in zip(procs, text) if p.returncode)
            fail(f"data-parallel: a rank failed:\n{bad[-4000:]}")
    raise AssertionError("unreachable")


def run_data_parallel(torch, np, device, cfg, root: str) -> dict:
    """Phase 10 (see the module docstring). Returns the printed numbers."""
    from sassd_tpu_torch import inference
    from sassd_tpu_torch.data import kitti
    from sassd_tpu_torch.weights import seeded_detector
    t0 = time.perf_counter()
    write_dp_splits(root)
    train_ds, val_ds, cfg_pts, samples, label_dir = dp_data(cfg, root)
    batches = [kitti.collate(samples[2 * t:2 * t + 2])[0]
               for t in range(DP_STEPS)]
    anchors = train_ds.anchors

    # 10a: world size 1
    ref, group, again, copies, backend = run_dp_world_one(
        torch, device, cfg, anchors, batches)
    check_launched(group[4], TRAIN_PHASE_IDS,
                   f"data-parallel, world size 1 ({backend})")
    print(f"data-parallel, world size 1 ({backend}): launches {group[4]}")
    (rm, rg, rbn, rs, _), (gm, gg, gbn, gs, _), (am, ag, abn, as_, _) = (
        ref, group, again)
    pairs = {"group vs none": (gm, gg, gbn, gs), "none vs none": (am, ag,
                                                                 abn, as_)}
    diffs = {}
    for what, (m, g, bn, st) in pairs.items():
        loss1 = max_abs_diff(torch, {k: v for k, v in m[0].items()
                                     if k != "grad_norm"},
                             {k: v for k, v in rm[0].items()
                              if k != "grad_norm"})
        diffs[what] = dict(
            losses_step1=loss1, bn_step1=max_abs_diff(torch, bn, rbn),
            grad_norms=max(abs(a["grad_norm"] - b["grad_norm"])
                           for a, b in zip(m, rm)),
            losses=max(max_abs_diff(torch, a, b) for a, b in zip(m, rm)),
            grads_step1=max_abs_diff(torch, g, rg),
            state=max_abs_diff(torch, st, rs),
            module_l2=max(module_l2(torch, g, rg).values()))
        print(f"data-parallel, world size 1, {what}: largest |difference| "
              + ", ".join(f"{k} {v:.3g}" for k, v in diffs[what].items()))
    if not (copies and all(copies) and len(copies) == DP_STEPS):
        fail(f"data-parallel, world size 1: the coalesced all-reduce is "
             f"not a copy ({copies})")
    d, ctl = diffs["group vs none"], diffs["none vs none"]
    for k in ("losses_step1", "bn_step1"):
        if d[k] != 0.0:
            fail(f"data-parallel, world size 1: {k} differ from the run "
                 f"with no group by {d[k]:.3g}")
    repeatable = all(v == 0.0 for v in ctl.values())
    if repeatable:
        bad = [k for k, v in d.items() if v != 0.0]
        if bad:
            fail(f"data-parallel, world size 1: {bad} differ from the "
                 f"run with no group, which repeats itself bitwise")
    else:
        # the backward's atomics (K11) add in another order each run:
        # step 1's gradients are held to phase 8's tolerances for runs
        # apart by that order alone; the later steps follow Adam's
        # updates of those gradients and are printed beside the control
        gn_err = (abs(gm[0]["grad_norm"] - rm[0]["grad_norm"])
                  / rm[0]["grad_norm"])
        if gn_err > PLANS_GNORM_RTOL or d["module_l2"] > PLANS_GRAD_L2:
            fail(f"data-parallel, world size 1: step 1's grad norm "
                 f"{gn_err:.3g}, module L2 {d['module_l2']:.3g} apart from "
                 f"the run with no group")
        print(f"data-parallel, world size 1: the run with no group does "
              f"not repeat itself bitwise (the backward's atomics), so "
              f"step 1's gradients are held to phase 8's atomics-order "
              f"tolerances: grad norm {gn_err:.3g} (<= {PLANS_GNORM_RTOL}),"
              f" module L2 {d['module_l2']:.3g} (<= {PLANS_GRAD_L2}); the "
              f"later steps are not gated")
    print(f"data-parallel, world size 1: step 1's losses and BatchNorm "
          f"buffers bitwise equal to the run with no group; the "
          f"{len(copies)} coalesced reductions are copies")

    # 10b and 10c: two ranks on the one device over gloo
    if device.type == "cuda":
        torch.cuda.empty_cache()        # the ranks' room on the card
    t = time.perf_counter()
    ranks = run_dp_ranks(torch, device, cfg, root)
    ranks_s = time.perf_counter() - t
    for r, res in enumerate(ranks):
        check_launched(res["launches"], TRAIN_PHASE_IDS,
                       f"data-parallel, rank {r} of 2, training")
        check_launched(res["eval_launches"], SERVE_PHASE_IDS,
                       f"data-parallel, rank {r} of 2, evaluate")
    r0, r1 = ranks
    rank_diff = max_abs_diff(torch, r0["state"], r1["state"])
    if rank_diff != 0.0 or r0["metrics"] != r1["metrics"]:
        fail(f"data-parallel, 2 ranks: the replicas differ after "
             f"{DP_STEPS} steps (largest |difference| {rank_diff:.3g})")
    m1, ref1 = r0["metrics"][0], rm[0]
    loss_err = {k: abs(m1[k] - v) / abs(v) for k, v in ref1.items()
                if "loss" in k}
    gn_err = abs(m1["grad_norm"] - ref1["grad_norm"]) / ref1["grad_norm"]
    mod_err = module_l2(torch, r0["grads"], rg)
    print(f"data-parallel, 2 ranks over gloo on one card: replicas bitwise "
          f"equal after {DP_STEPS} steps; step 1 against the single-process "
          f"batch-2 step: losses rel {max(loss_err.values()):.3g} "
          f"(<= {TRAIN_LOSS_RTOL}), grad norm {m1['grad_norm']:.7g} vs "
          f"{ref1['grad_norm']:.7g} rel {gn_err:.3g} (<= {TRAIN_GNORM_RTOL}),"
          f" module rel L2 " + ", ".join(f"{k} {v:.3g}" for k, v in
                                          mod_err.items())
          + f" (<= {TRAIN_GRAD_L2}); guided_valid {m1['guided_valid']:g} vs "
          f"{ref1['guided_valid']:g}, guided_pos {m1['guided_pos']:g} vs "
          f"{ref1['guided_pos']:g}")
    bad = [k for k, v in loss_err.items() if not v <= TRAIN_LOSS_RTOL]
    if (bad or not gn_err <= TRAIN_GNORM_RTOL
            or max(mod_err.values()) > TRAIN_GRAD_L2):
        fail(f"data-parallel, 2 ranks: step 1 disagrees with the "
             f"single-process step on {bad or 'the gradients'}")

    if (r1["results"], r1["text"], r1["parts"]) != (None, "", None):
        fail("data-parallel, evaluate: rank 1 returned a result")
    parts = r0["parts"]
    annos, ids = inference._dedup_by_id(
        [a for p in parts for a in p[0]], [i for p in parts for i in p[1]])
    model = seeded_detector(cfg, SEED, device)
    ref_annos, ref_ids = inference._dedup_by_id(*inference.run_inference(
        cfg_pts, val_ds, model, 1, device))
    if ids != ref_ids:
        fail(f"data-parallel, evaluate: samples {ids} vs {ref_ids}")
    counts = [match_annos(np, a, b, f"data-parallel, evaluate, sample {i}")
              for a, b, i in zip(annos, ref_annos, ids)]
    _, ref_text = inference.evaluate(cfg_pts, val_ds, None, label_dir,
                                     precomputed=(ref_annos, ref_ids))
    same = "equal" if r0["text"] == ref_text else "DIFFERENT"
    print(f"data-parallel, evaluate on 2 ranks: rank 0 gathered "
          f"{[len(p[1]) for p in parts]} samples, detections match the "
          f"single-process run_inference on {len(ids)} scans ({counts} "
          f"detections); AP table {same} to the single-process one (not "
          f"gated)")
    wall = time.perf_counter() - t0
    print(f"data-parallel: phase 10 took {wall:.1f} s (the two rank "
          f"processes {ranks_s:.1f} s)")
    return dict(wall_s=wall, ranks_s=ranks_s, world1=diffs,
                ranks_state_diff=rank_diff, loss_err=loss_err,
                gnorm_err=gn_err, module_l2=mod_err, detections=counts)


CLI_MULTI_IDS = "K1 K3 K3b K4 K5 K5b K6 K7 K10 K11 K12 K13 K14"
CLI_TEST_IDS = "K1 K2 K3 K4 K5"


def cli_worker(argv) -> int:
    """One CLI process of phase 11: argv = record file, tool name, the
    tool's arguments. Runs ``sassd_tpu_torch.tools.<tool>.main`` with the
    launch counters reset just before and read just after, records every
    train step's metrics (loop.make_train_step wrapped), the optimizer's
    final count and hyperparameters and its weight-decay scope, and
    run_inference's annotations, and pickles them to the record file."""
    out, name, args = argv[0], argv[1], argv[2:]
    sys.path.insert(0, HERE)
    import importlib
    import pickle
    from sassd_tpu_torch import inference
    from sassd_tpu_torch.train import loop
    rec = {"steps": [], "annos": None}
    make_step, run_inf = loop.make_train_step, inference.run_inference

    def make_train_step(cfg, anchors, optimizer, device):
        step = make_step(cfg, anchors, optimizer, device)
        rec["optimizer"] = optimizer

        def recorded(model, batch):
            m = step(model, batch)
            rec["steps"].append({k: float(v) for k, v in m.items()})
            return m
        return recorded

    def run_inference(*a, **kw):
        rec["annos"] = run_inf(*a, **kw)
        return rec["annos"]
    loop.make_train_step, inference.run_inference = make_train_step, \
        run_inference
    tool = importlib.import_module(f"sassd_tpu_torch.tools.{name}")
    reset_launches()
    rc = tool.main(args)
    rec.update(rc=rc, launches=read_launches())
    opt = rec.pop("optimizer", None)
    if opt is not None:
        rec.update(count=opt.count, hyperparams=opt.hyperparams(),
                   decay_all=all(opt.decay.values()))
    with open(out, "wb") as f:
        pickle.dump(rec, f)
    return rc


def start_cli(root: str, tag: str, tool: str, *args):
    """Start one CLI process of phase 11 (cli_worker) in the background;
    its output goes to root/{tag}.log, its record to root/{tag}.pkl."""
    log = open(os.path.join(root, f"{tag}.log"), "w+")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cli-worker",
         os.path.join(root, f"{tag}.pkl"), tool, *args],
        cwd=HERE, stdout=log, stderr=subprocess.STDOUT, text=True)
    return dict(tag=tag, proc=proc, log=log, root=root,
                t0=time.perf_counter())


def finish_cli(run: dict, want_rc: int = 0) -> dict:
    """Wait for a CLI process (killed past CLI_TIMEOUT_S) and return its
    record with its output ("text") and wall seconds; fail unless it
    exited `want_rc`."""
    import pickle
    proc = run["proc"]
    try:
        proc.wait(timeout=max(CLI_TIMEOUT_S - (time.perf_counter()
                                               - run["t0"]), 1))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    run["log"].seek(0)
    text = run["log"].read()
    run["log"].close()
    if proc.returncode != want_rc:
        fail(f"CLI {run['tag']}: exit {proc.returncode}, not {want_rc}:\n"
             f"{text[-4000:]}")
    with open(os.path.join(run["root"], f"{run['tag']}.pkl"), "rb") as f:
        rec = pickle.load(f)
    rec.update(text=text, wall_s=time.perf_counter() - run["t0"])
    print(f"  CLI {run['tag']}: exit {proc.returncode} in "
          f"{rec['wall_s']:.1f} s, {len(rec['steps'])} train steps")
    return rec


def wrapper_config(root: str, name: str, base: str, **replace) -> str:
    """A config file under root that loads the config file `base` and
    replaces the given fields (sections as dicts of fields); returns its
    path."""
    lines = ["import dataclasses",
             "from sassd_tpu.config import load_config",
             f"_c = load_config({base!r})"]
    fields = []
    for k, v in replace.items():
        if isinstance(v, dict):
            inner = ", ".join(f"{f}={x!r}" for f, x in v.items())
            fields.append(f"{k}=dataclasses.replace(_c.{k}, {inner})")
        else:
            fields.append(f"{k}={v!r}")
    lines.append(f"config = dataclasses.replace(_c, {', '.join(fields)})")
    path = os.path.join(root, name)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def check_train_record(np, rec: dict, n_steps: int, what: str) -> None:
    """Every recorded step finite with no skipped update."""
    if len(rec["steps"]) != n_steps:
        fail(f"{what}: {len(rec['steps'])} train steps, not {n_steps}")
    for i, m in enumerate(rec["steps"]):
        if not all(np.isfinite(v) for v in m.values()):
            fail(f"{what}: step {i}: a non-finite metric {m}")
        if m["nonfinite_skips"]:
            fail(f"{what}: step {i} skipped its update")


def run_pointnet_vfe(torch, np, device, cfg, root: str) -> dict:
    """Phase 11d: the PointNet VFE on `cfg` (the car config) on the card
    against the CPU: forward_test detections as sets, and one train
    step's losses against the CPU forward_train's (TRAIN_LOSS_RTOL)."""
    import dataclasses
    from sassd_tpu_torch import inference
    from sassd_tpu_torch.data import kitti, synthetic
    from sassd_tpu_torch.data.loader import iterate_batches
    from sassd_tpu_torch.train import loop, optim
    from sassd_tpu_torch.weights import seeded_detector
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, vfe_type="pointnet"))
    synthetic.write_synthetic_kitti(
        root, n_train=2, n_val=0, seed=SEED + 5,
        point_cloud_range=cfg.voxel.point_cloud_range)
    ds = kitti.KittiDataset(cfg, os.path.join(root, "training"),
                            os.path.join(root, "ImageSets", "train.txt"),
                            train=True)
    batch = next(iter(iterate_batches(ds, 2, shuffle=False,
                                      num_workers=0)))[0]
    model_dev = seeded_detector(cfg, SEED, device)
    model_cpu = seeded_detector(cfg, SEED, "cpu")
    dets = {}
    for where, model, dev in (("card", model_dev, device),
                              ("cpu", model_cpu, "cpu")):
        step = inference.make_test_step(cfg, ds.anchors, dev)
        dets[where] = {k: v.cpu().numpy()
                       for k, v in step(model, batch).items()}
    n = [match_detections({k: v[i] for k, v in dets["card"].items()},
                          {k: v[i] for k, v in dets["cpu"].items()},
                          f"PointNet VFE, scan {i}: card vs CPU")
         for i in range(2)]
    if sum(n) == 0:
        fail("PointNet VFE: no detections to compare")
    model_cpu.train()
    with torch.no_grad():
        ref = model_cpu.forward_train(
            inference.to_device(batch, "cpu"),
            torch.from_numpy(ds.anchors))
    opt = optim.make_optimizer(model_dev, cfg.train, 10)
    got = loop.make_train_step(cfg, ds.anchors, opt, device)(model_dev,
                                                             batch)
    worst = 0.0
    for k, v in ref.items():
        if "loss" not in k:
            continue
        r, g = float(v), float(got[k])
        err = abs(g - r) / max(abs(r), 1e-12)
        worst = max(worst, err)
        if not err <= TRAIN_LOSS_RTOL:
            fail(f"PointNet VFE: train step {k} card {g} vs CPU {r} "
                 f"({err:.2e} > {TRAIN_LOSS_RTOL})")
    if float(got["nonfinite_skips"]):
        fail("PointNet VFE: the card's train step skipped its update")
    print(f"PointNet VFE (car width): detections card vs CPU matched "
          f"{n}; one train step's losses within {worst:.2e} of the CPU's")
    return dict(matched=n, loss_rel=worst)


def run_cli(torch, np, device, root: str) -> dict:
    """Phase 11 (see the module docstring). Returns the printed numbers."""
    import dataclasses
    from sassd_tpu_torch.config import load_config
    from sassd_tpu_torch.data import kitti
    from sassd_tpu_torch.data.loader import iterate_batches
    from sassd_tpu_torch.inference import evaluate, run_inference
    from sassd_tpu_torch.models.detector import Detector
    from sassd_tpu_torch.tools import make_synth_corpus
    from sassd_tpu_torch.train import checkpoint as ckpt, loop, optim
    t0 = time.perf_counter()
    car = CLI_CAR
    # the CLIs run on the card by default; a CPU rehearsal asks for the CPU
    dev_args = [] if device.type == "cuda" else ["--device", "cpu"]
    work = {k: os.path.join(root, k)
            for k in ("whole", "whole2", "split", "multi")}
    corpus = os.path.join(root, "multi_corpus")
    make_synth_corpus.main([corpus, "--n_train", str(CLI_CORPUS[0]),
                            "--n_val", str(CLI_CORPUS[1]),
                            "--seed", str(SEED)])
    multi_cfg = wrapper_config(
        root, "multi_r3.py", CLI_MULTI,
        data=dict(root=corpus,
                  info_path=os.path.join(corpus, "ImageSets", "train.txt"),
                  db_info_path=os.path.join(corpus,
                                            "kitti_dbinfos_train.pkl")),
        train=dict(total_epochs=1), work_dir=work["multi"])
    train_args = ["--synthetic", "--epochs", str(CLI_EPOCHS), *dev_args]
    runs = [start_cli(root, "whole", "train", car, "--work_dir",
                      work["whole"], *train_args),
            start_cli(root, "split1", "train", car, "--work_dir",
                      work["split"], *train_args, "--epochs_per_run", "1"),
            start_cli(root, "multi", "train", multi_cfg, *dev_args),
            # a second uninterrupted run: how far two runs drift apart
            # without a relaunch (the control of 11a's distance)
            start_cli(root, "whole2", "train", car, "--work_dir",
                      work["whole2"], *train_args)]
    try:
        vfe = run_pointnet_vfe(torch, np, device, load_config(car),
                               os.path.join(root, "vfe"))
        split1 = finish_cli(runs[1], 75)
        runs.append(start_cli(root, "split2", "train", car, "--work_dir",
                              work["split"], *train_args,
                              "--epochs_per_run", "1"))
        whole, multi = finish_cli(runs[0]), finish_cli(runs[2])
        whole2, split2 = finish_cli(runs[3]), finish_cli(runs[4])
    finally:
        for r in runs:
            if r["proc"].poll() is None:
                r["proc"].kill()
                r["proc"].wait()
    # 11a: the uninterrupted and the relaunched runs
    cfg = load_config(car)
    data = os.path.join(work["split"], "synthetic_kitti")
    ds = kitti.KittiDataset(cfg, os.path.join(data, "training"),
                            os.path.join(data, "ImageSets", "train.txt"),
                            train=True)
    spe = -(-len(ds) // cfg.train.batch_size)
    check_train_record(np, whole, spe * CLI_EPOCHS, "CLI whole")
    check_train_record(np, whole2, spe * CLI_EPOCHS, "CLI whole2")
    check_train_record(np, split1, spe, "CLI split, first launch")
    check_train_record(np, split2, spe * (CLI_EPOCHS - 1),
                       "CLI split, relaunch")
    for rec, what in ((whole, "CLI whole"), (split1, "CLI split1"),
                      (split2, "CLI split2")):
        check_launched(rec["launches"], TRAIN_PHASE_IDS, what)
    final = {k: torch.load(os.path.join(work[k],
                                        f"checkpoint_epoch_{CLI_EPOCHS - 1}"
                                        ".pt"), weights_only=True)
             for k in ("whole", "whole2", "split")}
    ends = {k: (final[k]["step"], final[k]["optimizer"]["count"], r["count"],
                r["hyperparams"]) for k, r in (("whole", whole),
                                               ("split", split2))}
    if ends["whole"] != ends["split"] or ends["whole"][0] != spe * CLI_EPOCHS:
        fail(f"CLI: (step, saved count, count, (lr, momentum)) whole "
             f"{ends['whole']} vs relaunched {ends['split']}")
    # how far apart two runs end: parameters by their largest difference
    # and relative L2, BatchNorm statistics by relative L2
    names = {k for k, _ in Detector(cfg).named_parameters()}

    def distance(a, b):
        def rel_l2(keys):
            num = sum(float(((a[k] - b[k]).double() ** 2).sum())
                      for k in keys)
            den = sum(float((a[k].double() ** 2).sum()) for k in keys)
            return (num / max(den, 1e-300)) ** 0.5
        return dict(param_max=max(float((a[k] - b[k]).abs().max())
                                  for k in names),
                    param_rel_l2=rel_l2(names),
                    bn_rel_l2=rel_l2([k for k in a if k not in names]))
    diff = {what: distance(final["whole"]["model"], final[k]["model"])
            for what, k in (("relaunched", "split"), ("control", "whole2"))}
    print(f"CLI 11a: whole and relaunched runs end at step "
          f"{ends['whole'][0]}, count {ends['whole'][1]}, lr/momentum "
          f"{ends['whole'][3]} (not gated below: K11's backward atomics)")
    for what, d in diff.items():
        print(f"CLI 11a: final weights, whole vs {what} "
              f"{'(a second uninterrupted run) ' if what == 'control' else ''}"
              f"parameters max |diff| {d['param_max']:.3e}, relative L2 "
              f"{d['param_rel_l2']:.3e}; BatchNorm statistics relative L2 "
              f"{d['bn_rel_l2']:.3e}")
    # the relaunch's first step against a step taken here from the same
    # checkpoint on the same batch
    model = Detector(cfg).to(device)
    opt = optim.make_optimizer(model, cfg.train, spe * CLI_EPOCHS)
    ckpt.restore(os.path.join(work["split"], "checkpoint_epoch_0.pt"), model,
                 opt)
    batch = next(iter(iterate_batches(ds, cfg.train.batch_size, epoch=1,
                                      seed=cfg.train.seed, shuffle=True,
                                      num_workers=0)))[0]
    here = {k: float(v) for k, v in loop.make_train_step(
        cfg, ds.anchors, opt, device)(model, batch).items()}
    first = split2["steps"][0]
    losses = [k for k in here if "loss" in k]
    off = [k for k in losses if here[k] != first[k]]
    if off or not losses:
        fail(f"CLI 11a: the relaunch's first step differs from the "
             f"in-process step from its checkpoint: "
             f"{[(k, first[k], here[k]) for k in off]}")
    print(f"CLI 11a: the relaunch's first step's {len(losses)} losses equal "
          f"the in-process step's bit for bit (loss {here['loss']:.6f})")
    # 11b: tools.test on the relaunched run's final checkpoint
    test_cfg = wrapper_config(root, "car_test.py", car, data=dict(root=data))
    final_pt = os.path.join(work["split"],
                            f"checkpoint_epoch_{CLI_EPOCHS - 1}.pt")
    out = os.path.join(root, "results")
    test = finish_cli(start_cli(root, "test", "test", test_cfg, final_pt,
                                "--out", out, *dev_args))
    check_launched(test["launches"], CLI_TEST_IDS, "CLI test")
    tcfg = load_config(test_cfg)
    val = kitti.KittiDataset(tcfg, os.path.join(data, "training"),
                             os.path.join(data, "ImageSets", "val.txt"))
    model = Detector(tcfg)
    ckpt.restore(final_pt, model)
    model.to(device)
    annos, ids = run_inference(tcfg, val, model, 1, device)
    got_annos, got_ids = test["annos"]
    if list(got_ids) != list(ids):
        fail(f"CLI test: samples {got_ids} vs {ids}")
    n_det = [match_annos(np, g, a, f"CLI test, scan {i}")
             for g, a, i in zip(got_annos, annos, ids)]
    _, text = evaluate(tcfg, val, model,
                       os.path.join(data, "training", "label_2"),
                       device=device, precomputed=(annos, ids))
    if text.strip() not in test["text"]:
        fail(f"CLI test: its AP text differs from evaluate's:\n{text}")
    files = sorted(os.listdir(out))
    if files != [f"{i:06d}.txt" for i in ids]:
        fail(f"CLI test: result files {files}")
    print(f"CLI 11b: tools.test matched the in-process run on {len(ids)} "
          f"scans ({n_det} detections), AP text equal, {len(files)} result "
          f"files")
    # 11c: configs/multi_convergence_r3.py on the small corpus
    n_multi = -(-CLI_CORPUS[0] // load_config(multi_cfg).train.batch_size)
    check_train_record(np, multi, n_multi, "CLI multi_convergence_r3")
    check_launched(multi["launches"], CLI_MULTI_IDS,
                   "CLI multi_convergence_r3")
    if not multi["decay_all"]:
        fail("CLI multi_convergence_r3: weight_decay_mode='all' did not "
             "decay every parameter")
    print(f"CLI 11c: multi_convergence_r3 ({n_multi} steps at batch 1, "
          f"device plans, weight decay on every parameter, GT database) "
          f"losses {[round(m['loss'], 4) for m in multi['steps']]}")
    wall = time.perf_counter() - t0
    procs = {k: r["wall_s"] for k, r in (
        ("whole", whole), ("whole2", whole2), ("split1", split1),
        ("split2", split2), ("multi", multi), ("test", test))}
    print(f"CLI: phase 11 took {wall:.1f} s (process wall s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in procs.items()) + ")")
    return dict(wall_s=wall, diff=diff, vfe=vfe, procs=procs)


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "sassd_tpu_torch")):
        fail("sassd_tpu_torch is not next to chip_smoke.py; run it from a "
             "checkout of the repository")
    if sys.argv[1:2] == ["--dp-worker"]:
        return dp_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--cli-worker"]:
        return cli_worker(sys.argv[2:])
    sys.path.insert(0, HERE)
    import dataclasses
    import numpy as np
    import torch

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()
    card = smi[0] if smi else "<nvidia-smi printed nothing>"
    print(f"device: {name} ({torch.cuda.device_count()} visible); "
          f"nvidia-smi: {card}")
    from sassd_tpu_torch.config import car_config
    from sassd_tpu_torch.data import kitti, synthetic
    from sassd_tpu_torch.ops import build, cuda, native, riou_kernel
    from sassd_tpu_torch.ops import sparse as sp
    from sassd_tpu_torch.weights import seeded_detector
    print(run([cuda.nvcc(), "--version"]).splitlines()[-1:])

    t = time.perf_counter()
    native.load()
    host_s = time.perf_counter() - t
    t = time.perf_counter()
    cuda.load()
    kern_s = time.perf_counter() - t
    print(f"build: host library {host_s:.1f} s, CUDA kernels {kern_s:.1f} s "
          f"({len(cuda.SOURCES)} nvcc in parallel + link)")
    for line in build.BUILD_LOG.get("sassd_kernels", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())

    cfg = car_config()
    if "--data-parallel-only" in sys.argv[1:]:
        with tempfile.TemporaryDirectory() as root:
            run_data_parallel(torch, np, device, cfg, root)
        print(card)
        return 0
    if "--cli-only" in sys.argv[1:]:
        with tempfile.TemporaryDirectory() as root:
            run_cli(torch, np, device, root)
        print(card)
        return 0
    cfg_dev = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, host_plans=False))
    anchors, anchors_bv = kitti.build_anchors(cfg)
    rng = np.random.default_rng(SEED)
    scenes = [synthetic.make_scene(rng, n_cars=(6, 12), n_ground=18000)
              for _ in range(N_SCANS)]
    scans = [p for p, _, _ in scenes]
    t = time.perf_counter()
    samples = [kitti.prepare_scan(cfg, p, anchors_bv) for p in scans]
    host_ms = (time.perf_counter() - t) * 1e3 / N_SCANS
    t = time.perf_counter()
    samples_dev = [kitti.prepare_scan(cfg_dev, p, anchors_bv) for p in scans]
    host_dev_ms = (time.perf_counter() - t) * 1e3 / N_SCANS
    if any(k.startswith("plan_") for k in samples_dev[0]):
        fail("prepare_scan built host plans with host_plans=False")
    n_vox = [int((s["coords"][:, 0] >= 0).sum()) for s in samples]
    print(f"host leg ms/scan: {host_ms:.1f} with the C++ rulebook, "
          f"{host_dev_ms:.1f} without (voxelize + mask); active voxels "
          f"{n_vox}")

    t = time.perf_counter()
    train_samples = [kitti.prepare_scan(cfg, p, anchors_bv, train=True)
                     for p in scans[:2]]
    train_host_ms = (time.perf_counter() - t) * 1e3 / 2
    print(f"host leg ms/scan with the C++ train rulebook (strideT, aux): "
          f"{train_host_ms:.1f}")
    g = cfg.caps.max_gt
    gts = (np.zeros((2, g, 7), np.float32), np.zeros((2, g), bool))
    for i, (_, bx, _) in enumerate(scenes[:2]):
        gts[0][i, :len(bx)] = bx[:g]
        gts[1][i, :len(bx)] = True

    rows = check_kernels(torch, np, device)
    rows += check_sparse_kernels(torch, np, device, cfg, samples)
    rows += check_train_kernels(torch, np, device, cfg, train_samples, gts)
    rows += check_train_plan_kernels(torch, np, device, cfg, train_samples)
    frustum = synthetic.make_scene(np.random.default_rng(SEED + 2),
                                   n_cars=(6, 12), n_ground=18000,
                                   frustum=True)[0]
    rows += check_serving_kernels(torch, np, device, cfg, scans + [frustum],
                                  anchors_bv)
    model_dev = seeded_detector(cfg, SEED, device)
    k1_row = next(r for r in rows if r["name"] == "K1 rotate_overlap")
    nms_boxes_in, k3_inputs = serving_inputs(torch, np, device, cfg,
                                             model_dev)
    nms = check_nms_input(torch, riou_kernel, nms_boxes_in)
    k1_row["max_abs_err"] = max(k1_row["max_abs_err"], nms.pop("max_abs_err"))
    k1_row.update(nms)
    rows.append(check_k3_serving(torch, k3_inputs))
    if "--kernels-only" in sys.argv[1:]:
        # phases 1-3 and phase 9's kernel checks alone: the kernel rows of
        # this checkout under their own key (no launch counts, no result
        # line), for comparing two checkouts in one call
        with tempfile.TemporaryDirectory() as root:
            lr = long_range_inputs(np, root)
            rows += check_banded_kernels(torch, np, device, lr["cfg_b"],
                                         lr["spec"], lr["batch"],
                                         lr["t_batch"])
        for r in rows:
            print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms")
        print(json.dumps({"kernels_only": rows}))
        print(card)
        return 0

    model = seeded_detector(cfg, SEED, "cpu")               # CPU copy
    host = run_phase(torch, np, device, cfg, model_dev, anchors, samples,
                     "host plans")
    dev = run_phase(torch, np, device, cfg_dev, model_dev, anchors,
                    samples_dev, "device plans")
    with tempfile.TemporaryDirectory() as root:
        serving = run_serving(torch, np, device, cfg, model_dev, model,
                              root)
    with tempfile.TemporaryDirectory() as root:
        training = run_training(torch, np, device, cfg, root)
    with tempfile.TemporaryDirectory() as root:
        multi_runs, multi_step = run_multi_training(torch, np, device, root,
                                                    training[2])
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        lr_rows, lr_runs, lr_step, lr_ms, lr_train_ms = run_long_range(
            torch, np, device, root)
    print(f"long range: phase 9 took {time.perf_counter() - t:.1f} s")
    rows += lr_rows
    for r in rows:
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms")
    # K7' and K11' are K7 and K11 called with a limit and with origins:
    # the banded phases are the only callers that pass them
    symbols = kernel_symbols()
    for what, launches, ids in (("host plans", host[4], "K1 K2 K3 K4 K5"),
                                ("device plans", dev[4],
                                 "K1 K2 K3 K4 K5 K6 K7"),
                                ("serving", serving[0],
                                 "K1 K2 K3 K4 K5 K6 K7 K8 K9"),
                                ("training", training[0],
                                 "K1 K3 K3b K4 K5 K5b K10 K11 K12"),
                                ("three-class training, ring",
                                 multi_runs["ring"], "K1 K3 K3b K4 K5 K5b "
                                 "K6 K7 K10 K11 K12 K13 K14"),
                                ("three-class training, exact",
                                 multi_runs["exact"], "K1 K3 K3b K4 K5 K5b "
                                 "K6 K7 K10 K12 K13 K15"),
                                ("long range, banded inference",
                                 lr_runs["banded"],
                                 "K1 K2 K3 K4 K5 K6 K16 K7'"),
                                ("long range, replicated inference",
                                 lr_runs["replicated"],
                                 "K1 K2 K3 K4 K5 K6 K7"),
                                ("long range, banded training",
                                 lr_runs["training"], "K1 K3 K3b K4 K5 K5b "
                                 "K6 K10 K12 K13 K14 K16 K7' K11'")):
        check_launched(launches, ids, what)
    exact = multi_runs["exact"]
    if exact["sassd_ring_interp_bwd"] == 0:
        fail("three-class training, exact: K11's backward was not launched")
    if (any(exact[s] for s in sp.KERNEL_SYMBOLS["K14"])
            or exact["sassd_ring_interp_fwd"]):
        fail("three-class training, exact: the ring aux path ran")
    if lr_runs["replicated"]["sassd_band_partition"]:
        fail("long range, replicated inference: the band partition ran")
    for i in range(N_SCANS):
        match_detections(dev[0][i], host[0][i],
                         f"scan {i}: device plans vs host plans")
    print(f"device plans agree with host plans on all {N_SCANS} scans")
    check_cpu(np, cfg, model, anchors, samples[0], host[0][0], "host plans")
    check_cpu(np, cfg_dev, model, anchors, samples_dev[0], dev[0][0],
              "device plans")
    with tempfile.TemporaryDirectory() as root:
        data_parallel = run_data_parallel(torch, np, device, cfg, root)
    with tempfile.TemporaryDirectory() as root:
        cli = run_cli(torch, np, device, root)

    for what, (_, _, ms1, ms2, _) in (("host plans", host),
                                      ("device plans", dev)):
        print(f"car config, {what}, on {name} [{card}]: batch 1 "
              f"{', '.join(f'{m:.2f}' for m in ms1)} ms/scan; batch 2 "
              f"{ms2:.2f} ms ({ms2 / 2:.2f} ms/scan)")
    _, ms1, ms2, serve_host_ms, _ = serving
    print(f"car config, serving (raw points uploaded in the step), on "
          f"{name} [{card}]: batch 1 {', '.join(f'{m:.2f}' for m in ms1)} "
          f"ms/scan; batch 2 {', '.join(f'{m:.2f}' for m in ms2)} ms/scan; "
          f"host leg (prepare_points) {serve_host_ms:.2f} ms/scan")
    _, _, train_ms, train_leg_ms, _ = training
    print(f"car config, training at batch 2, on {name} [{card}]: "
          f"{', '.join(f'{m:.2f}' for m in train_ms)} ms/step (host clock, "
          f"synchronised, loader excluded); host leg (read + voxelize + "
          f"mask + C++ train rulebook) {train_leg_ms:.2f} ms/step")
    print(f"car config, data-parallel training (phase 10), on {name} "
          f"[{card}]: {data_parallel['wall_s']:.1f} s, the two gloo ranks "
          f"{data_parallel['ranks_s']:.1f} s")
    print(f"CLIs (phase 11), on {name} [{card}]: {cli['wall_s']:.1f} s; "
          f"processes (s) " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in cli["procs"].items()))
    for what in ("banded", "replicated"):
        print(f"long range, {what}, timing scan at batch 1, on {name} "
              f"[{card}]: {', '.join(f'{m:.2f}' for m in lr_ms[what])} "
              f"ms/scan; train step at batch 2 (comparison scans): "
              f"{', '.join(f'{m:.2f}' for m in lr_train_ms[what])} ms/step "
              f"(host clock, synchronised, loader excluded)")
    banded_phases = (("long range, banded inference", lr_runs["banded"]),
                     ("long range, banded training", lr_runs["training"]))
    all_phases = (("host plans", host[4]), ("device plans", dev[4]),
                  ("serving", serving[0]), ("training", training[0]),
                  ("three-class training, ring", multi_runs["ring"]),
                  ("three-class training, exact", multi_runs["exact"]),
                  ("long range, replicated inference",
                   lr_runs["replicated"])) + banded_phases
    banded_step = (("long range banded training, batch 2", lr_step),)
    all_steps = (("serving, batch 1", serving[4]),
                 ("training, batch 2", training[1]),
                 ("three-class training, ring, batch 1", multi_step["ring"]),
                 ("three-class training, exact, batch 1",
                  multi_step["exact"])) + banded_step
    for r in rows:
        kid = r["name"].split()[0]
        primed = kid.endswith("'")
        by_phase = {what: sum(launches[s] for s in symbols[kid])
                    for what, launches in (banded_phases if primed
                                           else all_phases)}
        r["launches"] = sum(by_phase.values())
        r["launches_by_phase"] = by_phase
        r["launches_per_step"] = {
            what: sum(launches[s] for s in symbols[kid])
            for what, launches in (banded_step if primed else all_steps)}
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
