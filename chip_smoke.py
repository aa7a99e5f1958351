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

Phase 3 also holds K8 (device voxelizer) and K9 (anchors mask) against
their plain versions, bitwise, on the car scans (at the 20,000-voxel cap,
so the lowest-key truncation runs) and on one frustum scan.

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
    rows.append(dict(name="K1 rotate_overlap", route="cuda",
                     source="sassd_tpu_torch/csrc/riou_overlap.cu",
                     replaces="sassd_tpu/ops/pallas/riou_kernel.py:137",
                     max_abs_err=err1, ms=ms, plain_ms=plain_ms))

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
                     max_abs_err=float(err2), ms=ms, plain_ms=plain_ms))

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
                     max_abs_err=err3, ms=ms, plain_ms=plain_ms))
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
        k4.append((f"{plan_key[5:]} {cin}->{cout}", err, ms, plain_ms))
    rows.append(dict(name="K4 sparse_conv", route="cuda",
                     source="sassd_tpu_torch/csrc/sparse_conv.cu",
                     replaces="sassd_tpu/ops/sparse.py:411",
                     max_abs_err=max(e for _, e, _, _ in k4),
                     ms=sum(m for _, _, m, _ in k4),
                     plain_ms=sum(m for _, _, _, m in k4),
                     at="sum over " + ", ".join(n for n, *_ in k4),
                     per_shape={n: dict(ms=m, plain_ms=pm)
                                for n, _, m, pm in k4}))

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
    rows.append(dict(name="K5 densify", route="cuda",
                     source="sassd_tpu_torch/csrc/densify.cu",
                     replaces="sassd_tpu/ops/sparse.py:835",
                     max_abs_err=err5, ms=ms, plain_ms=plain_ms))

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
    rows.append(dict(name="K6 device_plans", route="cuda",
                     source="sassd_tpu_torch/csrc/device_plans.cu",
                     replaces="sassd_tpu/ops/sparse.py:84",
                     max_abs_err=err6, ms=ms, plain_ms=plain_ms,
                     at="L0 index map + subm0 plan, batch 1"))
    ms = cuda_ms(lambda: sp.downsample_keys(keys0, shapes[0], caps[1]))
    plain_ms = cuda_ms(lambda: sp.downsample_keys_plain(keys0, shapes[0],
                                                        caps[1]))
    print(f"  K7 L0->L1 downsample (batch 1, incl. torch.sort): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
    rows.append(dict(name="K7 downsample", route="cuda",
                     source="sassd_tpu_torch/csrc/downsample.cu",
                     replaces="sassd_tpu/ops/sparse.py:618",
                     max_abs_err=err7, ms=ms, plain_ms=plain_ms,
                     at="L0 -> L1, batch 1, torch.sort included"))
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
    rows.append(dict(name="K8 voxelize", route="cuda",
                     source="sassd_tpu_torch/csrc/voxelize.cu",
                     replaces="sassd_tpu/ops/voxelize.py:142",
                     max_abs_err=err8, ms=ms, plain_ms=plain_ms,
                     at="batch 1, 65,536-point cap, torch.sort included"))
    ms = cuda_ms(lambda: serve.anchors_mask(c1, corners, hw, thr))
    plain_ms = cuda_ms(lambda: serve.anchors_mask_plain(c1, corners, hw,
                                                        thr))
    print(f"  K9 batch 1: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    rows.append(dict(name="K9 anchors_mask", route="cuda",
                     source="sassd_tpu_torch/csrc/anchors_mask.cu",
                     replaces="sassd_tpu/serve.py:106",
                     max_abs_err=err9, ms=ms, plain_ms=plain_ms,
                     at="batch 1, 20,000 voxels, 70,400 anchors"))
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
    evaluator. Returns (launches, ms1, ms2, host_ms)."""
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
    return launches, ms1, ms2, host_ms


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
    from sassd_tpu_torch.data import kitti, synthetic
    from sassd_tpu_torch import serve
    from sassd_tpu_torch.ops import build, cuda, native
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
    scans = [synthetic.make_scene(rng, n_cars=(6, 12), n_ground=18000)[0]
             for _ in range(N_SCANS)]
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

    rows = check_kernels(torch, np, device)
    rows += check_sparse_kernels(torch, np, device, cfg, samples)
    frustum = synthetic.make_scene(np.random.default_rng(SEED + 2),
                                   n_cars=(6, 12), n_ground=18000,
                                   frustum=True)[0]
    rows += check_serving_kernels(torch, np, device, cfg, scans + [frustum],
                                  anchors_bv)
    for r in rows:
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms")

    model = seeded_detector(cfg, SEED)                      # CPU copy
    model_dev = seeded_detector(cfg, SEED, device)
    host = run_phase(torch, np, device, cfg, model_dev, anchors, samples,
                     "host plans")
    dev = run_phase(torch, np, device, cfg_dev, model_dev, anchors,
                    samples_dev, "device plans")
    with tempfile.TemporaryDirectory() as root:
        serving = run_serving(torch, np, device, cfg, model_dev, model,
                              root)
    symbols = {"K1": ("sassd_riou_overlap",), "K2": ("sassd_nms_keep",),
               "K3": ("sassd_pswarp_score",), **sp.KERNEL_SYMBOLS,
               **vox.KERNEL_SYMBOLS, **serve.KERNEL_SYMBOLS}
    for what, launches, ids in (("host plans", host[4], "K1 K2 K3 K4 K5"),
                                ("device plans", dev[4],
                                 "K1 K2 K3 K4 K5 K6 K7"),
                                ("serving", serving[0],
                                 "K1 K2 K3 K4 K5 K6 K7 K8 K9")):
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
    _, ms1, ms2, serve_host_ms = serving
    print(f"car config, serving (raw points uploaded in the step), on "
          f"{name} [{card}]: batch 1 {', '.join(f'{m:.2f}' for m in ms1)} "
          f"ms/scan; batch 2 {', '.join(f'{m:.2f}' for m in ms2)} ms/scan; "
          f"host leg (prepare_points) {serve_host_ms:.2f} ms/scan")
    for r in rows:
        kid = r["name"][:2]
        by_phase = {what: sum(launches[s] for s in symbols[kid])
                    for what, launches in (("host plans", host[4]),
                                           ("device plans", dev[4]),
                                           ("serving", serving[0]))}
        r["launches"] = sum(by_phase.values())
        r["launches_by_phase"] = by_phase
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
