"""KITTI official AP evaluation (numpy).

A copy of the JAX package's ``eval/kitti_eval.py``: the official KITTI
protocol (difficulty filtering, greedy matching, 41 recall thresholds,
AP@R11 and AP@R40 for bbox/bev/3d and AOS, strict and loose overlaps),
with the rotated BEV overlaps from the C++ host library
(``core/riou_np.py``). Bare line citations (``:17-36``, ``kitti_eval.py:...``)
are to the original SA-SSD ``mmdet/core/evaluation/kitti_eval.py``.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from sassd_tpu_torch.core import riou_np as riou
from sassd_tpu_torch.data import calib as calib_lib

CLASS_NAMES = ["Car", "Pedestrian", "Cyclist", "Van", "Person_sitting"]
MIN_HEIGHT = [40, 25, 25]
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.3, 0.5]
N_SAMPLE_PTS = 41


# ---------------------------------------------------------------------------
# annotation I/O
# ---------------------------------------------------------------------------

def empty_anno() -> Dict[str, np.ndarray]:
    return dict(name=np.array([]), truncated=np.array([]),
                occluded=np.array([]), alpha=np.array([]),
                bbox=np.zeros((0, 4)), dimensions=np.zeros((0, 3)),
                location=np.zeros((0, 3)), rotation_y=np.array([]),
                score=np.array([]))


def label_file_to_anno(path) -> Dict[str, np.ndarray]:
    """Parse a KITTI label/result file into an anno dict.

    dimensions are stored (l, h, w) following kitti_common.py:560-617.
    """
    objs = calib_lib.read_label(path) if Path(path).exists() else []
    if not objs:
        return empty_anno()
    return dict(
        name=np.array([o.type for o in objs]),
        truncated=np.array([o.truncation for o in objs]),
        occluded=np.array([o.occlusion for o in objs]),
        alpha=np.array([o.alpha for o in objs]),
        bbox=np.stack([o.box2d for o in objs]).astype(np.float64),
        dimensions=np.array([[o.l, o.h, o.w] for o in objs], np.float64),
        location=np.stack([o.t for o in objs]).astype(np.float64),
        rotation_y=np.array([o.ry for o in objs], np.float64),
        score=np.array([o.score for o in objs], np.float64))


def get_label_annos(label_dir, sample_ids) -> List[Dict[str, np.ndarray]]:
    return [label_file_to_anno(Path(label_dir) / f"{sid:06d}.txt")
            for sid in sample_ids]


# ---------------------------------------------------------------------------
# overlaps per metric
# ---------------------------------------------------------------------------

def image_box_overlap(boxes, qboxes, criterion: int = -1) -> np.ndarray:
    """Aligned 2D IoU/IoF (kitti_eval.py:95-122)."""
    n, k = boxes.shape[0], qboxes.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k))
    lt = np.maximum(boxes[:, None, :2], qboxes[None, :, :2])
    rb = np.minimum(boxes[:, None, 2:], qboxes[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    a1 = ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]))[:, None]
    a2 = ((qboxes[:, 2] - qboxes[:, 0]) * (qboxes[:, 3] - qboxes[:, 1]))[None]
    if criterion == -1:
        denom = a1 + a2 - inter
    elif criterion == 0:
        denom = a1
    else:
        denom = a2
    return inter / np.maximum(denom, 1e-9)


def bev_box_overlap(boxes, qboxes) -> np.ndarray:
    """Camera-frame BEV rotated IoU: columns (x, z, l, w, ry)."""
    return riou.rotate_iou_eval_np(boxes, qboxes, -1)


def d3_box_overlap(boxes, qboxes) -> np.ndarray:
    """Camera-frame 3D IoU (kitti_eval.py:131-162): boxes [N,7] =
    (x, y, z, l, h, w, ry) with y = box bottom in camera coords."""
    n, k = boxes.shape[0], qboxes.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k))
    rinc = riou.rotate_overlap_bev_np(boxes[:, [0, 2, 3, 5, 6]],
                                      qboxes[:, [0, 2, 3, 5, 6]])
    iw = (np.minimum(boxes[:, 1][:, None], qboxes[None, :, 1])
          - np.maximum((boxes[:, 1] - boxes[:, 4])[:, None],
                       (qboxes[:, 1] - qboxes[:, 4])[None, :]))
    inter = np.where(iw > 0, iw * rinc, 0.0)
    v1 = (boxes[:, 3] * boxes[:, 4] * boxes[:, 5])[:, None]
    v2 = (qboxes[:, 3] * qboxes[:, 4] * qboxes[:, 5])[None, :]
    return inter / np.maximum(v1 + v2 - inter, 1e-9)


def _anno_metric_boxes(anno, metric):
    if metric == 0:
        return anno["bbox"]
    cam = np.concatenate(
        [anno["location"], anno["dimensions"], anno["rotation_y"][:, None]], 1)
    if metric == 1:
        return cam[:, [0, 2, 3, 5, 6]]
    return cam


def compute_overlaps(gt_annos, dt_annos, metric) -> List[np.ndarray]:
    """Per-image [num_dt, num_gt] overlap matrices."""
    out = []
    for gt, dt in zip(gt_annos, dt_annos):
        g = _anno_metric_boxes(gt, metric)
        d = _anno_metric_boxes(dt, metric)
        if metric == 0:
            out.append(image_box_overlap(d, g))
        elif metric == 1:
            out.append(bev_box_overlap(d, g))
        else:
            out.append(d3_box_overlap(d, g))
    return out


# ---------------------------------------------------------------------------
# protocol core
# ---------------------------------------------------------------------------

def clean_data(gt, dt, current_class: int, difficulty: int):
    """Classify boxes as counted / ignored / removed (kitti_eval.py:39-92)."""
    cls_name = CLASS_NAMES[current_class].lower()
    ignored_gt, dc_bboxes, ignored_dt = [], [], []
    num_valid_gt = 0
    for i in range(len(gt["name"])):
        name = str(gt["name"][i]).lower()
        height = gt["bbox"][i, 3] - gt["bbox"][i, 1]
        if name == cls_name:
            valid_class = 1
        elif cls_name == "pedestrian" and name == "person_sitting":
            valid_class = 0
        elif cls_name == "car" and name == "van":
            valid_class = 0
        else:
            valid_class = -1
        ignore = (gt["occluded"][i] > MAX_OCCLUSION[difficulty]
                  or gt["truncated"][i] > MAX_TRUNCATION[difficulty]
                  or height <= MIN_HEIGHT[difficulty])
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if str(gt["name"][i]) == "DontCare":
            dc_bboxes.append(gt["bbox"][i])
    for i in range(len(dt["name"])):
        valid_class = 1 if str(dt["name"][i]).lower() == cls_name else -1
        height = abs(dt["bbox"][i, 3] - dt["bbox"][i, 1])
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    dc = (np.stack(dc_bboxes) if dc_bboxes else np.zeros((0, 4)))
    return num_valid_gt, np.array(ignored_gt), np.array(ignored_dt), dc


def get_thresholds(scores: np.ndarray, num_gt: int,
                   num_sample_pts: int = N_SAMPLE_PTS) -> np.ndarray:
    """Score thresholds hitting ~41 evenly spaced recall points (:17-36)."""
    scores = np.sort(scores)[::-1]
    thresholds, current_recall = [], 0.0
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)
                and i < len(scores) - 1):
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return np.array(thresholds)


def compute_statistics(overlaps, gt, dt, ignored_gt, ignored_det, dc_bboxes,
                       metric, min_overlap, thresh=0.0, compute_fp=False,
                       compute_aos=False):
    """TP/FP/FN matching for one image at one score threshold (:164-280).

    overlaps: [num_dt, num_gt].
    """
    dt_scores = dt["score"]
    det_size, gt_size = len(dt["name"]), len(gt["name"])
    assigned = np.zeros(det_size, bool)
    ignored_threshold = (dt_scores < thresh) if compute_fp else np.zeros(
        det_size, bool)
    NO_DET = -10000000
    tp = fp = fn = 0
    similarity = 0.0
    thresholds, deltas = [], []
    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        det_idx, valid_det = -1, NO_DET
        max_overlap, assigned_ignored = 0.0, False
        for j in range(det_size):
            if ignored_det[j] == -1 or assigned[j] or ignored_threshold[j]:
                continue
            overlap = overlaps[j, i]
            if (not compute_fp and overlap > min_overlap
                    and dt_scores[j] > valid_det):
                det_idx, valid_det = j, dt_scores[j]
            elif (compute_fp and overlap > min_overlap
                  and (overlap > max_overlap or assigned_ignored)
                  and ignored_det[j] == 0):
                max_overlap, det_idx = overlap, j
                valid_det, assigned_ignored = 1, False
            elif (compute_fp and overlap > min_overlap and valid_det == NO_DET
                  and ignored_det[j] == 1):
                det_idx, valid_det, assigned_ignored = j, 1, True
        if valid_det == NO_DET and ignored_gt[i] == 0:
            fn += 1
        elif valid_det != NO_DET and (ignored_gt[i] == 1
                                      or ignored_det[det_idx] == 1):
            assigned[det_idx] = True
        elif valid_det != NO_DET:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            if compute_aos:
                deltas.append(gt["alpha"][i] - dt["alpha"][det_idx])
            assigned[det_idx] = True
    if compute_fp:
        for j in range(det_size):
            if not (assigned[j] or ignored_det[j] in (-1, 1)
                    or ignored_threshold[j]):
                fp += 1
        nstuff = 0
        if metric == 0 and len(dc_bboxes):
            ov_dc = image_box_overlap(dt["bbox"], dc_bboxes, 0)
            for i in range(len(dc_bboxes)):
                for j in range(det_size):
                    if (assigned[j] or ignored_det[j] in (-1, 1)
                            or ignored_threshold[j]):
                        continue
                    if ov_dc[j, i] > min_overlap:
                        assigned[j] = True
                        nstuff += 1
        fp -= nstuff
        if compute_aos:
            tmp = [(1.0 + np.cos(d)) / 2.0 for d in deltas]
            similarity = float(np.sum(tmp)) if (tp > 0 or fp > 0) else -1.0
    return tp, fp, fn, similarity, np.array(thresholds)


def compute_statistics_fused(overlaps, gt, dt, ignored_gt, ignored_det,
                             dc_bboxes, metric, min_overlap, thresholds,
                             compute_aos=False) -> np.ndarray:
    """All-threshold TP/FP/FN/AOS for one image, vectorized over thresholds.

    The numpy analog of the reference's fused_compute_statistics
    (kitti_eval.py:295-343): the greedy GT loop is kept (assignment order is
    part of the protocol) but the detection scan inside it runs as [T, D]
    array ops across every score threshold at once — this is what makes
    full-val-split evaluation tractable without numba. Semantics are
    byte-identical to looping `compute_statistics(..., compute_fp=True)`
    over thresholds (asserted by tests/test_eval.py's oracle test).

    Returns pr[T, 4] = (tp, fp, fn, similarity-sum) per threshold.
    """
    thresholds = np.asarray(thresholds, np.float64)
    T = len(thresholds)
    scores = np.asarray(dt["score"], np.float64)
    D, G = len(dt["name"]), len(gt["name"])
    pr = np.zeros((T, 4))
    if D == 0:
        pr[:, 2] = np.sum(np.asarray(ignored_gt) == 0)
        return pr
    ig_det = np.asarray(ignored_det)
    ig_thr = scores[None, :] < thresholds[:, None]            # [T, D]
    assigned = np.zeros((T, D), bool)
    tp = np.zeros(T, np.int64)
    fn = np.zeros(T, np.int64)
    sim = np.zeros(T)
    for i in range(G):
        if ignored_gt[i] == -1:
            continue
        ovi = np.asarray(overlaps[:, i], np.float64)          # [D]
        cand = ~assigned & ~ig_thr & (ovi > min_overlap)[None, :]
        valid0 = cand & (ig_det == 0)[None, :]
        valid1 = cand & (ig_det == 1)[None, :]
        has0 = valid0.any(1)
        has1 = valid1.any(1)
        # max-overlap det among real candidates (argmax = first max, same
        # tie order as the scalar scan); else the FIRST ignored candidate
        best0 = np.where(valid0, ovi[None, :], -np.inf).argmax(1)
        first1 = valid1.argmax(1)
        det = np.where(has0, best0, np.where(has1, first1, -1))  # [T]
        matched = det >= 0
        if ignored_gt[i] == 0:
            fn += ~matched
        safe = np.clip(det, 0, None)
        is_stuffed = matched & ((ignored_gt[i] == 1) | (ig_det[safe] == 1))
        is_tp = matched & ~is_stuffed
        tp += is_tp
        if compute_aos:
            delta = gt["alpha"][i] - np.asarray(dt["alpha"])[safe]
            sim += np.where(is_tp, (1.0 + np.cos(delta)) / 2.0, 0.0)
        rows = np.nonzero(matched)[0]
        assigned[rows, det[rows]] = True
    fp_mask = ~assigned & ~ig_thr & (ig_det == 0)[None, :]
    fp = fp_mask.sum(1)
    if metric == 0 and len(dc_bboxes):
        ov_dc = image_box_overlap(dt["bbox"], dc_bboxes, 0)
        in_dc = (ov_dc > min_overlap).any(1)                  # [D]
        fp -= (fp_mask & in_dc[None, :]).sum(1)
    pr[:, 0], pr[:, 1], pr[:, 2], pr[:, 3] = tp, fp, fn, sim
    return pr


def eval_class(gt_annos, dt_annos, current_class: int, difficulty: int,
               metric: int, min_overlap: float, compute_aos: bool = False,
               overlaps: Optional[List[np.ndarray]] = None):
    """Precision/recall/AOS curves at N_SAMPLE_PTS thresholds (:549-656).

    `overlaps` may be precomputed (they depend only on the metric) and
    shared across classes / difficulties / overlap settings — the analog of
    the reference's calculate_iou_partly being hoisted out of the
    per-difficulty loop (kitti_eval.py:569-571).
    """
    if overlaps is None:
        overlaps = compute_overlaps(gt_annos, dt_annos, metric)
    cleaned = [clean_data(g, d, current_class, difficulty)
               for g, d in zip(gt_annos, dt_annos)]
    total_valid_gt = sum(c[0] for c in cleaned)

    all_thresholds = []
    for i, (gt, dt) in enumerate(zip(gt_annos, dt_annos)):
        _, _, _, _, th = compute_statistics(
            overlaps[i], gt, dt, cleaned[i][1], cleaned[i][2], cleaned[i][3],
            metric, min_overlap, compute_fp=False)
        all_thresholds += th.tolist()
    thresholds = get_thresholds(np.array(all_thresholds),
                                max(total_valid_gt, 1))

    pr = np.zeros((len(thresholds), 4))
    for i, (gt, dt) in enumerate(zip(gt_annos, dt_annos)):
        pr += compute_statistics_fused(
            overlaps[i], gt, dt, cleaned[i][1], cleaned[i][2],
            cleaned[i][3], metric, min_overlap, thresholds, compute_aos)

    precision = np.zeros(N_SAMPLE_PTS)
    recall = np.zeros(N_SAMPLE_PTS)
    aos = np.zeros(N_SAMPLE_PTS)
    for t in range(len(thresholds)):
        denom_p = pr[t, 0] + pr[t, 1]
        denom_r = pr[t, 0] + pr[t, 2]
        precision[t] = pr[t, 0] / denom_p if denom_p > 0 else 0.0
        recall[t] = pr[t, 0] / denom_r if denom_r > 0 else 0.0
        if compute_aos:
            aos[t] = pr[t, 3] / denom_p if denom_p > 0 else 0.0
    # precision envelope (max over suffix, :645-650)
    for t in range(N_SAMPLE_PTS):
        precision[t] = precision[t:].max()
        recall[t] = recall[t:].max()
        if compute_aos:
            aos[t] = aos[t:].max()
    return dict(precision=precision, recall=recall, orientation=aos)


def ap11(prec: np.ndarray) -> float:
    """11-point AP (every 4th of 41 samples, :10-14)."""
    return float(prec[0::4].sum() / 11 * 100)


def ap40(prec: np.ndarray) -> float:
    """40-point AP (samples 1..40; the README's 'R40' protocol)."""
    return float(prec[1:].sum() / 40 * 100)


MIN_OVERLAPS = {  # per class: (strict, loose) for (bbox, bev, 3d)
    "Car": ((0.7, 0.7, 0.7), (0.7, 0.5, 0.5)),
    "Pedestrian": ((0.5, 0.5, 0.5), (0.5, 0.25, 0.25)),
    "Cyclist": ((0.5, 0.5, 0.5), (0.5, 0.25, 0.25)),
}


def get_official_eval_result(gt_annos, dt_annos, classes: Sequence[str]):
    """Full KITTI eval: AP@R11 and AP@R40 for bbox/bev/3d (+AOS when alphas
    are present), at BOTH overlap settings — strict (0.7/0.7/0.7 Car) and
    loose (0.7/0.5/0.5 Car), matching the reference's stacked min_overlaps
    tables (kitti_eval.py:791-798). Returns (results dict, text): strict APs
    live at results[cls][metric] (unchanged layout), the loose block at
    results[cls]["loose"][metric]."""
    compute_aos = any(
        len(a["alpha"]) and a["alpha"][0] != -10 for a in dt_annos)
    # overlap matrices depend only on the metric: compute each ONCE and
    # share across classes / difficulties / overlap settings
    metrics = [(0, "bbox"), (1, "bev"), (2, "3d")]
    overlaps_by_metric = {m: compute_overlaps(gt_annos, dt_annos, m)
                          for m, _ in metrics}
    results: Dict[str, Dict] = {}
    text = []
    for cls in classes:
        cidx = CLASS_NAMES.index(cls)
        results[cls] = {}
        for block, min_ovs in zip(("strict", "loose"), MIN_OVERLAPS[cls]):
            per_metric = {}
            for metric, name in metrics:
                r11, r40, aos11, aos40 = [], [], [], []
                for diff in range(3):
                    ret = eval_class(gt_annos, dt_annos, cidx, diff, metric,
                                     min_ovs[metric],
                                     compute_aos and metric == 0,
                                     overlaps=overlaps_by_metric[metric])
                    r11.append(ap11(ret["precision"]))
                    r40.append(ap40(ret["precision"]))
                    if compute_aos and metric == 0:
                        aos11.append(ap11(ret["orientation"]))
                        aos40.append(ap40(ret["orientation"]))
                per_metric[name] = dict(R11=r11, R40=r40)
                if aos11:
                    per_metric["aos"] = dict(R11=aos11, R40=aos40)
            if block == "strict":
                results[cls].update(per_metric)
            else:
                results[cls]["loose"] = per_metric
            text.append(f"{cls} AP@{min_ovs[0]:.2f}, {min_ovs[1]:.2f}, "
                        f"{min_ovs[2]:.2f}:")
            for name in ["bbox", "bev", "3d", "aos"]:
                if name in per_metric:
                    v11 = per_metric[name]["R11"]
                    v40 = per_metric[name]["R40"]
                    text.append(
                        f"{name:<4} AP R11: {v11[0]:.2f}, {v11[1]:.2f}, "
                        f"{v11[2]:.2f}  | R40: {v40[0]:.2f}, {v40[1]:.2f}, "
                        f"{v40[2]:.2f}")
    return results, "\n".join(text)
