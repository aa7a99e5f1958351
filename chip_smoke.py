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
   trained parameters. The train step is timed (host clock, synchronised,
   loader excluded) beside the host leg of a batch (voxelize + mask + the
   C++ train rulebook);
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
   skipped. The steps at batch 1 and 2 are timed beside a host-plans step.

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
   loss finite, band_overflow 0. Timed: the timing scan at batch 1, banded
   and replicated in turns, and the train step at batch 2.

Phase 3 holds K2 (NMS keep flags) bitwise against the plain greedy at
N = 2000 and at 1, 63, 64, 65 and 2113 boxes (the sweep's 64-box blocks
and its register words), at thresholds 0.1 and 0.5. It also holds K8
(device voxelizer) and K9 (anchors mask) against
their plain versions, bitwise, on the car scans (at the 20,000-voxel cap,
so the lowest-key truncation runs) and on one frustum scan, K8 also on a
batch of two with one sample empty and on phase 9's long-range timing
scan (262,144-point cap, 80,000 voxels: the bitmap follows the grid); and the
training kernels at batch 2 on the train plans of the car scans: K10
(sparse-conv weight gradient, also bitwise equal over two calls) and K4's
input gradients at the ladder's 10 training convs, K11 (ring 3-NN
interpolation, forward and backward), K12 (aux targets), K3b (PSWarp
backward) and K5b (densify backward); and the kernels of training on
device plans, at batch 2 on the same scans: K13 (transpose plans) and K14
(aux ring plans) against their plain versions and the C++ train rulebook,
bitwise, and K15 (exact 3-NN) at the full level sizes (rows, weights and
output bitwise, its backward through K11's).

K5, K5b, K6's level-0 map, K7 (the whole op, batch 1) and K13 are also
timed beside one PyTorch call that computes their work (library_ms), a
yardstick the port never calls; no single call computes K2's or K8's
function. K8's rows carry the parent design's torch.sort of the same
keys alone (sort_ms). K2, K8, K15 and the yardsticks are also timed as CUDA-graph replays (graph_ms, library_graph_ms: the
device's time without the host's launch path), except torch.unique,
which reads its output's size back to the host and cannot be captured.
K5b and K13 and their yardsticks are timed over 100 calls each, K5b and
its gather also with the L2 cold before each call (cold_l2_ms). K11 and
K11' (per level: the forward, the backward with its memset of d_feats,
that memset alone, the zeroing as torch.zeros, and forward + backward
replayed from one graph) and K16 are timed by events and graph replay. K2, K8, K11,
K11' and K16 also print torch.profiler's device time by kernel
(kernel_split) after their timed runs, as a diagnostic only: those
totals have read below the replay of the same call, so no row carries
them.

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
# K11 and K3b backwards add with atomics in an order that changes from run
# to run. K11's forward, K12 and K5b are held bitwise.
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

# the sparse ladder's 10 convs (models/backbone.py VxNet) as distinct
# shapes: name, plan, input level, Cin, Cout, convs of that shape
LADDER = (("conv0.0", "plan_subm0", 0, 4, 16, 1),
          ("conv0.1", "plan_subm0", 0, 16, 16, 1),
          ("down0", "plan_stride1", 0, 16, 32, 1),
          ("conv1", "plan_subm1", 1, 32, 32, 2),
          ("down1", "plan_stride2", 1, 32, 64, 1),
          ("conv2", "plan_subm2", 2, 64, 64, 3),
          ("down2", "plan_stride3", 2, 64, 64, 1))

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


def kernel_split(fn, iters: int = 10) -> dict:
    """Device milliseconds per call of each kernel (and memset) that fn()
    runs, by name, from torch.profiler over `iters` calls: the parts of one
    wrapper call."""
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
    got = riou_kernel.rotate_overlap(bt, bt, 2)
    ref = riou_kernel.rotate_overlap_plain(bt, bt, 2)
    err1 = float((got - ref).abs().max())
    deg = got[-8:, -8:].cpu().numpy()
    expect = {(0, 1): 8.0, (0, 2): 0.0, (0, 3): 2.0, (0, 4): 0.0,
              (0, 6): 4.0, (0, 7): 8.0}
    bad = {k: float(deg[k]) for k, v in expect.items()
           if abs(deg[k] - v) > 1e-2}
    print(f"K1 rotate_overlap {tuple(got.shape)}: max|kernel-plain| = "
          f"{err1:.3g} m^2 (tol {K1_ATOL}); degenerate pairs "
          f"{'ok' if not bad else bad}")
    if not err1 <= K1_ATOL or bad:
        fail("K1 disagrees with its plain version")
    ms = cuda_ms(lambda: riou_kernel.rotate_overlap(bt, bt, 2))
    plain_ms = cuda_ms(lambda: riou_kernel.rotate_overlap_plain(bt, bt, 2),
                       iters=5)
    n1 = bt.shape[0]
    rows.append(dict(name="K1 rotate_overlap", route="cuda",
                     source="sassd_tpu_torch/csrc/riou_overlap.cu",
                     replaces="sassd_tpu/ops/pallas/riou_kernel.py:137",
                     max_abs_err=err1, ms=ms, plain_ms=plain_ms,
                     library_ms=None,
                     library_what="none: torch has no rotated-box overlap",
                     # ~400 operations a pair: corners, 2 x 4 clipped edges
                     **bound(2 * n1 * 5 * 4 + n1 * n1 * 4, n1 * n1 * 400)))

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
    ms = cuda_ms(lambda: warp.pswarp_score(part_map, boxes3, valid, *args))
    plain_ms = cuda_ms(
        lambda: warp.pswarp_score_plain(part_map, boxes3, valid, *args),
        iters=5)
    rows.append(dict(name="K3 pswarp_score", route="cuda",
                     source="sassd_tpu_torch/csrc/pswarp_score.cu",
                     replaces="sassd_tpu/ops/warp.py:76",
                     max_abs_err=err3, ms=ms, plain_ms=plain_ms,
                     library_ms=None,
                     library_what="none: grid_sample samples every channel "
                                  "at every point; the part's channel and "
                                  "the mean take more calls",
                     # boxes, valid, scores; 4 map taps a part; ~70
                     # operations a part (lattice, sin/cos, 4 weights)
                     **bound(b * n * (7 * 4 + 1 + 4) + b * n * k * 4 * 4,
                             b * n * k * 70)))
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
    rows.append(dict(name="K6 device_plans", route="cuda",
                     source="sassd_tpu_torch/csrc/device_plans.cu",
                     replaces="sassd_tpu/ops/sparse.py:84",
                     max_abs_err=err6, ms=ms, plain_ms=plain_ms,
                     map_ms=map_ms, map_graph_ms=map_graph_ms,
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
    lib_ms = None
    if b == 1:
        cands = sp.downsample_candidates(keys, shape, y_limit)[0]
        lib_ms = cuda_ms(lambda: torch.unique(cands))
    print(f"  {name} ({at}): kernel {ms:.4f} ms ({dev_ms:.4f} replayed from "
          f"a CUDA graph), plain {plain_ms:.4f} ms; torch.unique of the "
          f"{8 * keys.shape[1]} candidates "
          f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}")
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
                             "uncapped); batch 1 only",
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
    timing scan."""
    from sassd_tpu_torch import serve
    from sassd_tpu_torch.config import long_range_config
    from sassd_tpu_torch.data import synthetic
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
    corners = torch.from_numpy(serve.anchor_corner_indices(
        anchors_bv, cfg.voxel.voxel_size, cfg.voxel.point_cloud_range,
        cfg.voxel.grid_size)).to(device)
    hw = (int(cfg.voxel.grid_size[1]), int(cfg.voxel.grid_size[0]))
    thr = cfg.data.anchor_area_threshold
    mask = serve.anchors_mask(coords8, corners, hw, thr)
    mask_ref = serve.anchors_mask_plain(coords8, corners, hw, thr)
    same9 = torch.equal(mask, mask_ref)
    err9 = float((mask.int() - mask_ref.int()).abs().max())
    print(f"K9 anchors_mask {tuple(coords8.shape)} -> {tuple(mask.shape)} "
          f"over a {hw[0]}x{hw[1]} grid: "
          f"{'bitwise equal to' if same9 else 'DIFFERS from'} plain; "
          f"anchors kept {mask.sum(1).tolist()}")
    if not same9:
        fail("K9 differs from its plain version")

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
    ms = cuda_ms(lambda: serve.anchors_mask(c1, corners, hw, thr))
    plain_ms = cuda_ms(lambda: serve.anchors_mask_plain(c1, corners, hw,
                                                        thr))
    n_anchors = corners.shape[0]
    # an estimate, printed only: the present design's floor, which adds
    # its [H, W] float32 integral image written once and read once to the
    # function's bytes
    image_ms = bound(c1.shape[1] * 12 + n_anchors * 17
                     + 2 * hw[0] * hw[1] * 4, 0)["bound_ms"]
    print(f"  K9 batch 1: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
          f"integral-image design floor (estimate, not the bound) "
          f"{image_ms:.4f} ms")
    rows.append(dict(name="K9 anchors_mask", route="cuda",
                     source="sassd_tpu_torch/csrc/anchors_mask.cu",
                     replaces="sassd_tpu/serve.py:106",
                     max_abs_err=err9, ms=ms, plain_ms=plain_ms,
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
    label, off = boxes.aux_targets(query, pvalid, gt, gv)
    ref_label, ref_off = boxes.aux_targets_plain(query, pvalid, gt, gv)
    same12 = torch.equal(label, ref_label) and torch.equal(off, ref_off)
    print(f"K12 aux_targets {tuple(query.shape)} x {tuple(gt.shape)}: "
          f"{'bitwise equal to' if same12 else 'DIFFERS from'} plain; "
          f"points in boxes {label.sum(1).tolist()}")
    if not same12 or not label.any():
        fail("K12 differs from its plain version (or no point is in a box)")
    ms = cuda_ms(lambda: boxes.aux_targets(query, pvalid, gt, gv))
    plain_ms = cuda_ms(lambda: boxes.aux_targets_plain(query, pvalid, gt,
                                                       gv))
    n_pts, n_box = int(pvalid.sum()), int(gv.sum(1).max())
    rows.append(dict(name="K12 aux_targets", route="cuda",
                     source="sassd_tpu_torch/csrc/points_in_boxes.cu",
                     replaces="sassd_tpu/core/boxes.py:281",
                     max_abs_err=float((off - ref_off).abs().max()), ms=ms,
                     plain_ms=plain_ms, library_ms=None,
                     library_what="none: torch has no points-in-rotated-"
                                  "boxes test",
                     at="batch 2, 20,000-voxel cap, 64 GT slots",
                     # points, validity, boxes in; labels, offsets out;
                     # ~25 operations a point-box test (sin and cos
                     # included), every valid box for a point in none
                     **bound(query.numel() * 4 + pvalid.numel()
                             + gt.numel() * 4 + gv.numel()
                             + label.numel() + off.numel() * 4,
                             n_pts * n_box * 25)))

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
    d_map, d_boxes = warp.pswarp_score_grad(part_map, boxes3, valid, d_score,
                                            *args)
    pm, pb = part_map.clone().requires_grad_(), boxes3.clone(
        ).requires_grad_()
    out_p = warp.pswarp_score_plain(pm, pb, valid, *args)
    ref_map, ref_boxes = torch.autograd.grad(out_p, (pm, pb), d_score,
                                             retain_graph=True)
    err3b = max(rel_err(d_map, ref_map), rel_err(d_boxes, ref_boxes))
    print(f"K3b pswarp_score_grad {tuple(part_map.shape)} x {n} boxes: rel "
          f"err map {rel_err(d_map, ref_map):.3g}, boxes "
          f"{rel_err(d_boxes, ref_boxes):.3g} (tol {TRAIN_GRAD_RTOL})")
    if not err3b <= TRAIN_GRAD_RTOL:
        fail("K3b disagrees with autograd of the plain version")
    ms = cuda_ms(lambda: warp.pswarp_score_grad(part_map, boxes3, valid,
                                                d_score, *args))
    plain_ms = grad_ms(out_p, (pm, pb), d_score)
    rows.append(dict(name="K3b pswarp_score_grad", route="cuda",
                     source="sassd_tpu_torch/csrc/pswarp_score.cu",
                     replaces="sassd_tpu/ops/warp.py:76",
                     max_abs_err=err3b, err_kind="relative to max |plain|",
                     ms=ms, plain_ms=plain_ms, library_ms=None,
                     library_what="none: as K3, grid_sample's backward "
                                  "covers every channel at every point",
                     at="batch 2, 640 boxes a sample",
                     # d_score, boxes, valid, 4 map taps a part in; the
                     # whole zeroed d_map and d_boxes out; ~100 operations
                     # a part
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


def level_centers(np, cfg, coords, level):
    """Cell centres [B, M, 3] xyz of a level's zyx coords (the aux branch's
    known points of the exact 3-NN)."""
    from sassd_tpu_torch.ops import interpolate as itp
    vs = np.asarray(cfg.voxel.voxel_size, np.float32) * 2 ** level
    pcr = np.asarray(cfg.voxel.point_cloud_range[:3], np.float32)
    return itp.cell_centers(coords, vs.tolist(), pcr.tolist())


def check_train_plan_kernels(torch, np, device, cfg, samples):
    """Phase 3, the kernels of training without host plans, at batch 2 on
    the train plans of the first two car scans: K13 (transpose plans) and
    K14 (aux ring plans) against their plain versions and the C++ train
    rulebook, bitwise; K15 (exact 3-NN) against its plain version at the
    full level sizes: rows, weights and features bitwise, and its backward
    (K11's) within TRAIN_GRAD_RTOL."""
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

    # K13 and K14 at the three levels
    k13, k14, diff, err = [], [], {}, {}
    for lvl in (1, 2, 3):
        plan = batch[f"plan_stride{lvl}"].to(torch.int32)
        got = sp.stride_plan_T(plan, caps[lvl - 1])
        ref = sp.stride_plan_T_plain(plan, caps[lvl - 1])
        host = batch[f"plan_strideT{lvl}"].to(torch.int32)
        diff[f"strideT{lvl}"] = (int((got != ref).sum()),
                                 int((got != host).sum()))
        err[f"strideT{lvl}"] = float((got - ref).abs().max())
        # K13 and its yardstick over 100 calls each, by events and as
        # CUDA-graph replays
        ms = cuda_ms(lambda: sp.stride_plan_T(plan, caps[lvl - 1]),
                     iters=100)
        dev_ms = graph_ms(lambda: sp.stride_plan_T(plan, caps[lvl - 1]),
                          iters=100)
        plain_ms = cuda_ms(lambda: sp.stride_plan_T_plain(plan,
                                                          caps[lvl - 1]))
        # one torch.full + index_put_ of the plan's found entries
        bk, kk, oo = torch.nonzero(plan >= 0, as_tuple=True)
        put_idx = (bk, kk, plan[bk, kk, oo].long())
        put_val = oo.to(torch.int32)
        shape_t = tuple(got.shape)

        def put13():
            out = torch.full(shape_t, -1, dtype=torch.int32, device=device)
            out.index_put_(put_idx, put_val)
        lib_ms = cuda_ms(put13, iters=100)
        k13.append((lvl, ms, plain_ms, dict(
            bound(plan.numel() * 4 + got.numel() * 4, 0), graph_ms=dev_ms,
            library_graph_ms=graph_ms(put13, iters=100)), lib_ms))
        keys = sp.coords_to_keys(batch[f"plan_coords{lvl}"], shapes[lvl])
        imap = sp.build_index_map(keys, shapes[lvl])
        got = sp.aux_plan(cell0, lvl, imap, shapes[lvl])
        ref = sp.aux_plan_plain(cell0, lvl, imap, shapes[lvl])
        host = batch[f"plan_aux{lvl}"].to(torch.int32)
        diff[f"aux{lvl}"] = (int((got != ref).sum()),
                             int((got != host).sum()))
        err[f"aux{lvl}"] = float((got - ref).abs().max())
        ms = cuda_ms(lambda: sp.aux_plan(cell0, lvl, imap, shapes[lvl]))
        plain_ms = cuda_ms(lambda: sp.aux_plan_plain(cell0, lvl, imap,
                                                     shapes[lvl]))
        n_valid = int((cell0[..., 0] >= 0).sum())
        # cells in, 27 map reads a valid row (at most the map), plan out
        k14.append((lvl, ms, plain_ms, bound(
            cell0.numel() * 4 + min(27 * n_valid, imap.numel()) * 4
            + got.numel() * 4, 0), None))
        del imap
    print(f"K13 stride_plan_T, K14 aux_plan, batch 2, levels 1-3: entries "
          f"differing (from plain, from the C++ train rulebook): {diff}; "
          f"max|kernel-plain|: {err}")
    if any(a or b for a, b in diff.values()):
        fail("K13 or K14 differs from its plain version or the C++ train "
             "rulebook")
    for name, src_line, parts, prefix, lib_what in (
            ("K13 stride_plan_T", "sassd_tpu/ops/sparse.py:732", k13,
             "strideT", "torch.full(-1) + index_put_ of the forward plan's "
                        "found entries"),
            ("K14 aux_plan", "sassd_tpu/ops/sparse.py:785", k14, "aux",
             None)):
        graphs = {}
        if lib_what:
            graphs = {k: sum(bd[k] for *_, bd, _ in parts)
                      for k in ("graph_ms", "library_graph_ms")}
            per = {lv: (round(bd["graph_ms"], 4),
                        round(bd["library_graph_ms"], 4))
                   for lv, *_, bd, _ in parts}
            print(f"  {name} per level (kernel, yardstick), replayed from "
                  f"CUDA graphs, 100 replays: {per}")
        rows.append(dict(name=name, route="cuda", **graphs,
                         source="sassd_tpu_torch/csrc/device_plans.cu",
                         replaces=src_line,
                         max_abs_err=max(v for k, v in err.items()
                                         if k.startswith(prefix)),
                         ms=sum(m for _, m, *_ in parts),
                         plain_ms=sum(m for _, _, m, *_ in parts),
                         library_ms=(lib_what and
                                     sum(lm for *_, lm in parts)),
                         library_what=lib_what or (
                             "none: the window's tap cells and edge masks "
                             "take several calls before one gather"),
                         at="batch 2, sum over levels 1-3",
                         per_level={lv: dict(ms=m, plain_ms=pm,
                                             library_ms=lm, **bd)
                                    for lv, m, pm, bd, lm in parts},
                         **add_bounds([bd for *_, bd, _ in parts])))
        per = [(lv, round(m, 4), round(pm, 4), lm and round(lm, 4))
               for lv, m, pm, _, lm in parts]
        print(f"  {name} per level (kernel, plain, one-call ms): {per}")

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
    import dataclasses
    from sassd_tpu_torch import inference, serve
    from sassd_tpu_torch.data import kitti, synthetic
    from sassd_tpu_torch.eval import results

    cfg_pts = dataclasses.replace(cfg, test=dataclasses.replace(
        cfg.test, device_input="points"))
    synthetic.write_synthetic_kitti(root, n_train=0, n_val=N_SCANS,
                                    seed=SEED)
    data_root = os.path.join(root, "training")
    ds = kitti.KittiDataset(cfg, data_root,
                            os.path.join(root, "ImageSets", "val.txt"))
    view = serve.PointsView(ds, cfg_pts)
    step = serve.make_serving_step(cfg_pts, ds.anchors, ds.anchors_bv,
                                   device)
    batch1 = [kitti.collate([view[i]])[0] for i in range(N_SCANS)]
    batch2 = [kitti.collate([view[i], view[i + 1]])[0]
              for i in range(0, N_SCANS, 2)]
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
    from sassd_tpu_torch.data import kitti, synthetic
    from sassd_tpu_torch.inference import to_device
    from sassd_tpu_torch.models.detector import Detector, parse_losses
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
    for name, where, dtype in (("cpu64", "cpu", torch.float64),
                               ("cpu", "cpu", torch.float32),
                               ("card", device, torch.float32)):
        model = weights.seeded_detector(cfg, SEED, where).to(dtype)
        model.train()
        b = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in to_device(batch, where).items()}
        t = time.perf_counter()
        losses = model.forward_train(b, anchors.to(where, dtype))
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
    return rows, launches, per_step, ms, train_ms


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "sassd_tpu_torch")):
        fail("sassd_tpu_torch is not next to chip_smoke.py; run it from a "
             "checkout of the repository")
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
    from sassd_tpu_torch.core import boxes
    from sassd_tpu_torch.data import kitti, synthetic
    from sassd_tpu_torch import serve
    from sassd_tpu_torch.ops import build, cuda, native, warp
    from sassd_tpu_torch.ops import interpolate as itp
    from sassd_tpu_torch.ops import sparse as sp
    from sassd_tpu_torch.ops import voxelize as vox
    from sassd_tpu_torch.parallel import sparse_spatial as ss
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
    model_dev = seeded_detector(cfg, SEED, device)
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
    symbols = {"K1": ("sassd_riou_overlap",), "K2": ("sassd_nms_keep",),
               **warp.KERNEL_SYMBOLS, **sp.KERNEL_SYMBOLS,
               **vox.KERNEL_SYMBOLS, **serve.KERNEL_SYMBOLS,
               **itp.KERNEL_SYMBOLS, **boxes.KERNEL_SYMBOLS,
               **ss.KERNEL_SYMBOLS, "K7'": sp.KERNEL_SYMBOLS["K7"],
               "K11'": itp.KERNEL_SYMBOLS["K11"]}
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
        idle = [s for k in ids.split() for s in symbols[k]
                if launches[s] == 0]
        if idle:
            fail(f"{what}: a kernel of the path was not launched: {idle}")
    exact = multi_runs["exact"]
    if exact["sassd_ring_interp_bwd"] == 0:
        fail("three-class training, exact: K11's backward was not launched")
    if exact["sassd_aux_plan"] or exact["sassd_ring_interp_fwd"]:
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
