#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sassd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card, nvcc and g++.
Phases, each of which fails the run (nonzero exit, no result line):

1. environment: torch/CUDA versions, the card, its power limit, nvcc;
2. build: the C++ host library (g++) and the CUDA kernels (nvcc), timed;
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the shapes of the car-config path, with stated tolerances,
   and both timed with CUDA events. K4 (sparse conv) and K5 (dense-tail
   scatter) run on the host plans of synthetic car scans; K6 (index maps +
   window plans) and K7 (downsample) build the device rulebook of those
   scans, which must equal both the plain versions and the C++ host
   rulebook bit for bit;
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
   C++ train rulebook).

Phase 3 also holds K8 (device voxelizer) and K9 (anchors mask) against
their plain versions, bitwise, on the car scans (at the 20,000-voxel cap,
so the lowest-key truncation runs) and on one frustum scan; and the
training kernels at batch 2 on the train plans of the car scans: K10
(sparse-conv weight gradient) and K4's input gradients, K11 (ring 3-NN
interpolation, forward and backward), K12 (aux targets), K3b (PSWarp
backward) and K5b (densify backward).

Every kernel row carries its bound: the larger of the bytes it must move
(each input read once, each output written once, at this run's active
counts) over the H100's 3.35 TB/s and its operations over the 67 TFLOP/s
of float32 outside the tensor cores.

The second-to-last lines are a JSON object of the kernels and the card's
name and power limit; the last line is the JSON result object.
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
N_TRAIN_EPOCHS = 3      # of 2 steps at batch 2 over the 4 train scans

# the card's peaks the bounds are taken against (H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


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


def nms_boxes(rng, n: int):
    """NMS-like candidates: clusters of jittered car boxes over the KITTI
    range, so that many pairs overlap."""
    import numpy as np
    n_obj = n // 20
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
                     # ~400 operations a pair: corners, 2 x 4 clipped edges
                     **bound(2 * n1 * 5 * 4 + n1 * n1 * 4, n1 * n1 * 400)))

    # K2: keep flags on the same boxes with random scores
    scores = torch.from_numpy(rng.uniform(0, 1, 2000).astype(np.float32))
    order = torch.argsort(-scores, stable=True).to(device)
    srt = bt[:2000][order].contiguous()
    iou = riou.rotate_iou_bev(srt, srt)
    keep0 = torch.from_numpy(rng.uniform(size=2000) < 0.95).to(device)
    err2 = 0
    for thr in (0.1, 0.5):
        k_got = riou.nms_keep(iou, keep0, thr)
        k_ref = riou.nms_keep_plain(iou, keep0, thr)
        n_diff = int((k_got != k_ref).sum())
        err2 = max(err2, n_diff)
        print(f"K2 nms_keep N=2000 thr={thr}: kept {int(k_got.sum())}, "
              f"flags differing from plain greedy: {n_diff}")
    if err2:
        fail("K2 keep flags differ from the plain greedy")
    ms = cuda_ms(lambda: riou.nms_keep(iou, keep0, 0.1))
    plain_ms = cuda_ms(lambda: riou.nms_keep_plain(iou, keep0, 0.1), iters=5)
    rows.append(dict(name="K2 nms_keep", route="cuda",
                     source="sassd_tpu_torch/csrc/rotate_nms.cu",
                     replaces="sassd_tpu/core/riou.py:188",
                     max_abs_err=float(err2), ms=ms, plain_ms=plain_ms,
                     library_ms=None,
                     **bound(2000 * 2000 * 4 + 2 * 2000, 2000 * 2000)))

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

    # K4 at L0 16->16, the stride conv L1->L2 32->64 and L2 64->64, on the
    # int16 wire plans of scan 0 (batch 1)
    k4 = []
    for plan_key, level_in, cin, cout in (("plan_subm0", 0, 16, 16),
                                          ("plan_stride2", 1, 32, 64),
                                          ("plan_subm2", 2, 64, 64)):
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
        print(f"K4 sparse_conv {plan_key[5:]} {tuple(plan.shape)} "
              f"{cin}->{cout}: max|kernel-plain| = {err:.3g} (rtol "
              f"{K4_RTOL}, atol {K4_ATOL}); kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms")
        if not ok:
            fail(f"K4 disagrees with its plain version on {plan_key}")
        found = int((plan >= 0).sum())
        k4.append((f"{plan_key[5:]} {cin}->{cout}", err, ms, plain_ms,
                   bound(feats.numel() * 4 + plan.numel() * plan.element_size()
                         + w.numel() * 4 + plan.shape[2] * cout * 4,
                         2 * found * cin * cout)))
    rows.append(dict(name="K4 sparse_conv", route="cuda",
                     source="sassd_tpu_torch/csrc/sparse_conv.cu",
                     replaces="sassd_tpu/ops/sparse.py:411",
                     max_abs_err=max(e for _, e, _, _, _ in k4),
                     ms=sum(m for _, _, m, _, _ in k4),
                     plain_ms=sum(m for _, _, _, m, _ in k4),
                     library_ms=None,
                     at="sum over " + ", ".join(n for n, *_ in k4),
                     per_shape={n: dict(ms=m, plain_ms=pm, **bd)
                                for n, _, m, pm, bd in k4},
                     **add_bounds([bd for *_, bd in k4])))

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
    plain_ms = cuda_ms(lambda: sp.densify_nchw_plain(keys3, x3, shapes[3]))
    print(f"K5 densify {tuple(x3.shape)} -> {tuple(canvas.shape)}: "
          f"{'bitwise equal to' if same5 else 'DIFFERS from'} plain; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    if not same5:
        fail("K5 differs from its plain version")
    d3, h3, w3 = shapes[3]
    rows.append(dict(name="K5 densify", route="cuda",
                     source="sassd_tpu_torch/csrc/densify.cu",
                     replaces="sassd_tpu/ops/sparse.py:835",
                     max_abs_err=err5, ms=ms, plain_ms=plain_ms,
                     library_ms=None,
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
    print(f"  K6 L0 map + subm0 plan (batch 1): kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms")
    m0 = keys0.shape[1]
    total0 = shapes[0][0] * shapes[0][1] * shapes[0][2]
    rows.append(dict(name="K6 device_plans", route="cuda",
                     source="sassd_tpu_torch/csrc/device_plans.cu",
                     replaces="sassd_tpu/ops/sparse.py:84",
                     max_abs_err=err6, ms=ms, plain_ms=plain_ms,
                     library_ms=None,
                     at="L0 index map + subm0 plan, batch 1",
                     # keys in, the whole map written, 27 map reads and
                     # one plan entry out per row and tap
                     **bound(m0 * 4 + total0 * 4 + 2 * 27 * m0 * 4, 0)))
    ms = cuda_ms(lambda: sp.downsample_keys(keys0, shapes[0], caps[1]))
    plain_ms = cuda_ms(lambda: sp.downsample_keys_plain(keys0, shapes[0],
                                                        caps[1]))
    print(f"  K7 L0->L1 downsample (batch 1, incl. torch.sort): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
    n_cand = 8 * m0
    rows.append(dict(name="K7 downsample", route="cuda",
                     source="sassd_tpu_torch/csrc/downsample.cu",
                     replaces="sassd_tpu/ops/sparse.py:618",
                     max_abs_err=err7, ms=ms, plain_ms=plain_ms,
                     library_ms=None,
                     at="L0 -> L1, batch 1, torch.sort included",
                     # keys in, the capped level out; a comparison sort of
                     # the 8 candidates a row
                     **bound(m0 * 4 + caps[1] * 4,
                             n_cand * int(np.ceil(np.log2(n_cand))))))
    return rows


def check_serving_kernels(torch, np, device, cfg, scans, anchors_bv):
    """Phase 3, K8 and K9: the device voxelizer and the anchors mask of
    raw car-config scans against their plain versions on the card."""
    from sassd_tpu_torch import serve
    from sassd_tpu_torch.ops.voxelize import voxelize, voxelize_plain

    prepared = [serve.prepare_points(p, cfg) for p in scans]
    pts = torch.from_numpy(np.stack([p for p, _ in prepared])).to(device)
    n = torch.from_numpy(np.asarray([k for _, k in prepared],
                                    np.int32)).to(device)
    got = voxelize(pts, n, cfg.voxel)
    ref = voxelize_plain(pts, n, cfg.voxel)
    same8 = all(torch.equal(a, b) for a, b in zip(got, ref))
    err8 = float(max((a.double() - b.double()).abs().max()
                     for a, b in zip(got, ref)))
    n_vox = (got[1][..., 0] >= 0).sum(1).tolist()
    print(f"K8 voxelize {tuple(pts.shape)}, n_points {n.tolist()}: "
          f"{'bitwise equal to' if same8 else 'DIFFERS from'} plain; "
          f"voxels {n_vox} (cap {cfg.voxel.max_voxels})")
    if not same8:
        fail("K8 differs from its plain version")
    corners = torch.from_numpy(serve.anchor_corner_indices(
        anchors_bv, cfg.voxel.voxel_size, cfg.voxel.point_cloud_range,
        cfg.voxel.grid_size)).to(device)
    hw = (int(cfg.voxel.grid_size[1]), int(cfg.voxel.grid_size[0]))
    thr = cfg.data.anchor_area_threshold
    mask = serve.anchors_mask(got[1], corners, hw, thr)
    mask_ref = serve.anchors_mask_plain(got[1], corners, hw, thr)
    same9 = torch.equal(mask, mask_ref)
    err9 = float((mask.int() - mask_ref.int()).abs().max())
    print(f"K9 anchors_mask {tuple(got[1].shape)} -> {tuple(mask.shape)} "
          f"over a {hw[0]}x{hw[1]} grid: "
          f"{'bitwise equal to' if same9 else 'DIFFERS from'} plain; "
          f"anchors kept {mask.sum(1).tolist()}")
    if not same9:
        fail("K9 differs from its plain version")

    p1, n1, c1 = pts[:1], n[:1], got[1][:1].contiguous()
    rows = []
    ms = cuda_ms(lambda: voxelize(p1, n1, cfg.voxel))
    plain_ms = cuda_ms(lambda: voxelize_plain(p1, n1, cfg.voxel))
    print(f"  K8 batch 1 (incl. torch.sort): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms")
    n_in = int(n1[0])
    v_cap = cfg.voxel.max_voxels
    rows.append(dict(name="K8 voxelize", route="cuda",
                     source="sassd_tpu_torch/csrc/voxelize.cu",
                     replaces="sassd_tpu/ops/voxelize.py:142",
                     max_abs_err=err8, ms=ms, plain_ms=plain_ms,
                     library_ms=None,
                     at="batch 1, 65,536-point cap, torch.sort included",
                     # the valid points in; voxels, coords and counts out;
                     # a comparison sort of the points' keys
                     **bound(n_in * 16 + v_cap * (cfg.voxel.max_num_points
                                                  * 16 + 12 + 4),
                             n_in * int(np.ceil(np.log2(max(n_in, 2)))))))
    ms = cuda_ms(lambda: serve.anchors_mask(c1, corners, hw, thr))
    plain_ms = cuda_ms(lambda: serve.anchors_mask_plain(c1, corners, hw,
                                                        thr))
    print(f"  K9 batch 1: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    n_anchors = corners.shape[0]
    rows.append(dict(name="K9 anchors_mask", route="cuda",
                     source="sassd_tpu_torch/csrc/anchors_mask.cu",
                     replaces="sassd_tpu/serve.py:106",
                     max_abs_err=err9, ms=ms, plain_ms=plain_ms,
                     library_ms=None,
                     at="batch 1, 20,000 voxels, 70,400 anchors",
                     # coords and corner indices in, the mask out
                     **bound(c1.shape[1] * 12 + n_anchors * 17,
                             c1.shape[1] + 4 * n_anchors)))
    return rows


def check_train_kernels(torch, np, device, cfg, samples, gts):
    """Phase 3, the training kernels at batch 2 on the train plans of the
    first two car scans: K10 and K4's input gradients, K11, K12, K3b, K5b.
    gts: [2, max_gt, 7] GT boxes and [2, max_gt] validity (the scenes')."""
    from sassd_tpu_torch.core import boxes
    from sassd_tpu_torch.ops import interpolate as itp
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

    # K10, and K4 as the input gradient, at L0 16->16, the stride conv
    # L1->L2 32->64 (K4 on the transpose plan) and L2 64->64
    k10, dx_err = [], 0.0
    for kind, level_in, cin, cout in (("subm0", 0, 16, 16),
                                      ("stride2", 1, 32, 64),
                                      ("subm2", 2, 64, 64)):
        plan = batch[f"plan_{kind}"]
        x = randn(2, caps[level_in], cin)
        w = randn(27, cin, cout, scale=1 / np.sqrt(27 * cin))
        cot = randn(2, plan.shape[2], cout)
        dw = sp.conv_weight_grad(x, plan, cot)
        dw_ref = sp.conv_weight_grad_plain(x, plan, cot)
        err = rel_err(dw, dw_ref)
        if kind.startswith("subm"):
            args = (plan,)
            fn = sp.subm_conv_sym
        else:
            args = (plan, batch[f"plan_strideT{kind[-1]}"])
            fn = sp.stride_conv_hostT
        xk, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
        fn(xk, w, *args).backward(cot)
        sp.subm_conv_batched_plain(xp, w, plan).backward(cot)
        dx_err = max(dx_err, rel_err(xk.grad, xp.grad))
        ms = cuda_ms(lambda: sp.conv_weight_grad(x, plan, cot))
        plain_ms = cuda_ms(lambda: sp.conv_weight_grad_plain(x, plan, cot))
        print(f"K10 conv_weight_grad {kind} {cin}->{cout} {tuple(plan.shape)}"
              f": rel err {err:.3g}; input gradient (K4) rel err "
              f"{rel_err(xk.grad, xp.grad):.3g} (tol {TRAIN_GRAD_RTOL}); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if not (err <= TRAIN_GRAD_RTOL and dx_err <= TRAIN_GRAD_RTOL):
            fail(f"K10 or K4's input gradient disagrees on {kind}")
        found = int((plan >= 0).sum())
        k10.append((f"{kind} {cin}->{cout}", err, ms, plain_ms,
                    bound(x.numel() * 4 + cot.numel() * 4
                          + plan.numel() * plan.element_size()
                          + dw.numel() * 4, 2 * found * cin * cout)))
    rows.append(dict(name="K10 conv_weight_grad", route="cuda",
                     source="sassd_tpu_torch/csrc/sparse_conv_bwd.cu",
                     replaces="sassd_tpu/ops/sparse.py:541",
                     max_abs_err=max(e for _, e, *_ in k10),
                     err_kind="relative to max |plain|",
                     input_grad_rel_err=dx_err,
                     ms=sum(m for _, _, m, _, _ in k10),
                     plain_ms=sum(m for _, _, _, m, _ in k10),
                     library_ms=None, at="batch 2, sum over " + ", ".join(
                         n for n, *_ in k10),
                     per_shape={n: dict(ms=m, plain_ms=pm, **bd)
                                for n, _, m, pm, bd in k10},
                     **add_bounds([bd for *_, bd in k10])))

    # K11 at the three levels: forward bitwise with identical selections,
    # backward within TRAIN_GRAD_RTOL
    npts = torch.clamp(batch["num_points"], min=1)[..., None].float()
    query = (batch["voxels"][..., :3].sum(-2) / npts).contiguous()
    cell0 = batch["coords"]
    pc = np.asarray(cfg.voxel.point_cloud_range[:3], np.float32).tolist()
    k11, err11 = [], 0.0
    for level, c in ((1, 32), (2, 64), (3, 64)):
        vs = (np.asarray(cfg.voxel.voxel_size, np.float32)
              * 2 ** level).tolist()
        plan = batch[f"plan_aux{level}"]
        feats = randn(2, caps[level], c)
        out, rsel, wsel = itp.ring_interp_fwd(query, cell0, level, feats,
                                              plan, vs, pc)
        ref_rows, ref_w = itp.ring_select_plain(query, cell0, level, plan,
                                                caps[level], vs, pc)
        ref = itp.neighborhood_interpolate_cells_plain(
            query, cell0, level, feats, plan, vs, pc)
        same = (torch.equal(rsel.long(), ref_rows)
                and torch.equal(wsel, ref_w) and torch.equal(out, ref))
        cot = randn(*out.shape)
        fk = feats.clone().requires_grad_()
        itp.neighborhood_interpolate_cells(query, cell0, level, fk, plan, vs,
                                           pc).backward(cot)
        fp = feats.clone().requires_grad_()
        out_p = itp.neighborhood_interpolate_cells_plain(query, cell0, level,
                                                         fp, plan, vs, pc)
        bwd_err = rel_err(fk.grad, torch.autograd.grad(
            out_p, fp, cot, retain_graph=True)[0])
        err11 = max(err11, bwd_err)
        print(f"K11 ring_interp level {level} {tuple(query.shape)} -> "
              f"{tuple(out.shape)}: forward, rows and weights "
              f"{'bitwise equal to' if same else 'DIFFER from'} plain; "
              f"backward rel err {bwd_err:.3g} (tol {TRAIN_GRAD_RTOL})")
        if not same or bwd_err > TRAIN_GRAD_RTOL:
            fail(f"K11 disagrees with its plain version at level {level}")
        ms = cuda_ms(lambda: itp.ring_interp_bwd(
            cot, rsel, wsel, feats.shape)) + cuda_ms(
            lambda: itp.ring_interp_fwd(query, cell0, level, feats, plan, vs,
                                        pc))
        plain_ms = grad_ms(out_p, fp, cot) + cuda_ms(
            lambda: itp.neighborhood_interpolate_cells_plain(
                query, cell0, level, feats, plan, vs, pc))
        src = (cot[:, :, None] * wsel.view(2, -1, 3, 1)).reshape(-1, c)
        flat = torch.zeros((2 * caps[level], c), device=device)
        lib_ms = cuda_ms(lambda: flat.index_add_(0, rsel.view(-1).long(),
                                                 src))
        q = query.shape[0] * query.shape[1]
        k11.append((level, ms, plain_ms, lib_ms, bound(
            q * (12 + 12 + 27 * plan.element_size() + 2 * c * 4 + 24)
            + min(feats.numel(), 3 * q * c) * 4 + feats.numel() * 4,
            q * (27 * 12 + 3 * c * 2 + 3 * c * 2))))
    rows.append(dict(name="K11 ring_interp", route="cuda",
                     source="sassd_tpu_torch/csrc/interpolate.cu",
                     replaces="sassd_tpu/ops/interpolate.py:115",
                     max_abs_err=err11, err_kind="backward, relative to max "
                     "|plain|; the forward is bitwise",
                     ms=sum(m for _, m, *_ in k11),
                     plain_ms=sum(m for _, _, m, *_ in k11),
                     library_ms=None,
                     library_backward_ms=sum(m for *_, m, _ in k11),
                     at="batch 2, forward + backward, levels 1-3",
                     per_level={lv: dict(ms=m, plain_ms=pm, **bd)
                                for lv, m, pm, _, bd in k11},
                     **add_bounds([bd for *_, bd in k11])))

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
    ms = cuda_ms(lambda: sp.densify_grad(keys3, d_canvas, shapes[3]))
    plain_ms = cuda_ms(lambda: sp.densify_grad_plain(keys3, d_canvas,
                                                     shapes[3]))
    n_rows = int((keys3 != sp.INVALID_KEY).sum())
    rows.append(dict(name="K5b densify_grad", route="cuda",
                     source="sassd_tpu_torch/csrc/densify.cu",
                     replaces="sassd_tpu/ops/sparse.py:835",
                     max_abs_err=float((got - ref).abs().max()), ms=ms,
                     plain_ms=plain_ms, library_ms=None,
                     at="batch 2, 10,240-row cap",
                     # keys and the active rows' canvas values in, rows out
                     **bound(keys3.numel() * 4 + n_rows * 64 * 4
                             + got.numel() * 4, 0)))
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
    from sassd_tpu_torch.ops import cuda

    step = make_test_step(cfg, anchors, device)
    batch1 = [kitti.collate([s])[0] for s in samples]
    batch2 = kitti.collate(samples[:2])[0]
    for b in batch1[:1] + [batch2]:                 # warm-up (cuDNN, build)
        step(model_dev, b)
    torch.cuda.synchronize()

    for kern in cuda.KERNELS.values():
        kern.launches = 0
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
    launches = {k: v.launches for k, v in cuda.KERNELS.items()}
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
    from sassd_tpu_torch.ops import cuda

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

    for kern in cuda.KERNELS.values():
        kern.launches = 0
    runs = {bs: inference.run_inference(cfg_pts, ds, model_dev, bs, device)
            for bs in (1, 2)}
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in cuda.KERNELS.items()}
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
    for kern in cuda.KERNELS.values():
        kern.launches = 0
    step(model_dev, batch1[0])
    torch.cuda.synchronize()
    per_step = {k: v.launches for k, v in cuda.KERNELS.items()}
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
    from sassd_tpu_torch.ops import cuda
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
    for kern in cuda.KERNELS.values():
        kern.launches = 0
    t = time.perf_counter()
    model, opt, steps = loop.train_model(cfg, ds, work,
                                         total_epochs=N_TRAIN_EPOCHS,
                                         device=device, logger=logger)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    launches = {k: v.launches for k, v in cuda.KERNELS.items()}
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
    step(model, batch)
    torch.cuda.synchronize()
    ms = []
    for _ in range(3):
        t = time.perf_counter()
        step(model, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    for kern in cuda.KERNELS.values():
        kern.launches = 0
    step(model, batch)
    torch.cuda.synchronize()
    per_step = {k: v.launches for k, v in cuda.KERNELS.items()}
    return launches, per_step, ms, host_ms, gl


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
    frustum = synthetic.make_scene(np.random.default_rng(SEED + 2),
                                   n_cars=(6, 12), n_ground=18000,
                                   frustum=True)[0]
    rows += check_serving_kernels(torch, np, device, cfg, scans + [frustum],
                                  anchors_bv)
    for r in rows:
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms")

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
    symbols = {"K1": ("sassd_riou_overlap",), "K2": ("sassd_nms_keep",),
               **warp.KERNEL_SYMBOLS, **sp.KERNEL_SYMBOLS,
               **vox.KERNEL_SYMBOLS, **serve.KERNEL_SYMBOLS,
               **itp.KERNEL_SYMBOLS, **boxes.KERNEL_SYMBOLS}
    for what, launches, ids in (("host plans", host[4], "K1 K2 K3 K4 K5"),
                                ("device plans", dev[4],
                                 "K1 K2 K3 K4 K5 K6 K7"),
                                ("serving", serving[0],
                                 "K1 K2 K3 K4 K5 K6 K7 K8 K9"),
                                ("training", training[0],
                                 "K1 K3 K3b K4 K5 K5b K10 K11 K12")):
        idle = [s for k in ids.split() for s in symbols[k]
                if launches[s] == 0]
        if idle:
            fail(f"{what}: a kernel of the path was not launched: {idle}")
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
    for r in rows:
        kid = r["name"].split()[0]
        by_phase = {what: sum(launches[s] for s in symbols[kid])
                    for what, launches in (("host plans", host[4]),
                                           ("device plans", dev[4]),
                                           ("serving", serving[0]),
                                           ("training", training[0]))}
        r["launches"] = sum(by_phase.values())
        r["launches_by_phase"] = by_phase
        r["launches_per_step"] = {
            what: sum(launches[s] for s in symbols[kid])
            for what, launches in (("serving, batch 1", serving[4]),
                                   ("training, batch 2", training[1]))}
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
