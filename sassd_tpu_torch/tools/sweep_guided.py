"""guided_train cap sweep: how many PSWarp positives a candidate cap cuts.

The reference keeps every anchor over the score threshold, plus the GT
boxes, as PSWarp's training candidates; this detector keeps the top
``caps.guided_train`` by score. On GT-pasted training scenes and a real
checkpoint's scores, this probe counts the candidates that pass the
threshold and the positives (3D IoU >= ``train.extra_pos_iou`` with a GT)
that a cap of each size keeps.

    python -m sassd_tpu_torch.tools.sweep_guided cfg.py ckpt.pt \\
        [--caps 640,1280,2560] [--scenes 16] [--device cpu]

The checkpoint is the port's ``.pt`` or a JAX ``.msgpack``; its parameters
and BatchNorm statistics are loaded. The scenes are the first ``--scenes``
training samples of ``{data.root}/ImageSets/train.txt`` (augmented as in
training when the config names a GT database). Each scene prints one row
(G GT boxes, n_pass candidates over the threshold, n_pos positives among
them, and per cap the positives kept and the candidates cut); a summary
follows.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sassd_tpu_torch.config import load_config
from sassd_tpu_torch.core import boxes as box_ops
from sassd_tpu_torch.core import riou
from sassd_tpu_torch.data.kitti import KittiDataset, collate
from sassd_tpu_torch.inference import to_device
from sassd_tpu_torch.models.detector import Detector
from sassd_tpu_torch.parallel import mesh
from sassd_tpu_torch.tools import full_float32
from sassd_tpu_torch.train import checkpoint


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config")
    ap.add_argument("checkpoint", help=".pt or JAX .msgpack checkpoint")
    ap.add_argument("--caps", default="640,1280,2560")
    ap.add_argument("--scenes", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def head_scores(model, batch: Dict, anchors):
    """The spine (eval mode) and the head on one batch of tensors -> (the
    best class's sigmoid score [B, A], decoded boxes [B, A, 7])."""
    model.eval()
    with torch.inference_mode():
        spine = model.forward_spine(batch)
        outs = model.head(spine.bev_map)
        scores = torch.sigmoid(outs.cls_preds).amax(dim=-1)
        return scores, box_ops.second_box_decode(outs.box_preds,
                                                 anchors[None])


def scene_row(cfg, i: int, scores: np.ndarray, decoded: np.ndarray,
              sample: Dict, caps: Sequence[int], device
              ) -> Tuple[Dict, np.ndarray]:
    """One scene's row, and the best GT IoU of each passing candidate
    (in anchor order). The 3D IoU runs on `device` (K1 on the card)."""
    mask = sample["anchors_mask"]
    gtb, gtv = sample["gt_boxes"], sample["gt_valid"]
    g = int(gtv.sum())
    idx = np.nonzero((scores > cfg.train.anchor_thr) & mask)[0]
    best = np.zeros(len(idx), np.float32)
    if len(idx) and g:
        iou = riou.rotate_iou_3d(
            torch.from_numpy(decoded[idx]).to(device),
            torch.from_numpy(gtb[gtv]).to(device))
        best = iou.amax(dim=1).cpu().numpy()
    pos = best >= cfg.train.extra_pos_iou
    # descending by score, ties in anchor order
    order = np.argsort(-scores[idx], kind="stable")
    row = dict(i=i, G=g, n_pass=len(idx), n_pos=int(pos.sum()))
    for cap in caps:
        k = cap - gtb.shape[0]          # the GT slots are always appended
        row[f"kept_pos_{cap}"] = int(pos[order[:k]].sum())
        row[f"trunc_{cap}"] = max(0, len(idx) - k)
    return row, best


def probe(cfg, model, dataset, caps: Sequence[int], n_scenes: int,
          device, report=None) -> List[Tuple[Dict, np.ndarray, np.ndarray]]:
    """(row, scores [A], best IoU of the passing candidates) of each of
    the first `n_scenes` samples; `report(row)` is called as each row is
    made."""
    anchors = torch.from_numpy(dataset.anchors).to(device)
    out = []
    for i in range(min(n_scenes, len(dataset))):
        batch, _ = collate([dataset[i]])
        ts, dec = head_scores(model, to_device(batch, device), anchors)
        ts, dec = ts[0].cpu().numpy(), dec[0].cpu().numpy()
        sample = {k: batch[k][0] for k in ("anchors_mask", "gt_boxes",
                                           "gt_valid")}
        row, best = scene_row(cfg, i, ts, dec, sample, caps, device)
        if report is not None:
            report(row)
        out.append((row, ts, best))
    return out


def summary(rows: List[Dict], caps: Sequence[int],
            elapsed_s: float) -> List[str]:
    """The summary lines printed after the rows."""
    n = len(rows)
    tot = sum(r["n_pos"] for r in rows)
    lines = [f"elapsed {elapsed_s:.1f}s over {n} scenes; "
             f"mean candidates {np.mean([r['n_pass'] for r in rows]):.1f} "
             f"(max {max(r['n_pass'] for r in rows)}), "
             f"mean GTs {np.mean([r['G'] for r in rows]):.1f}"]
    for cap in caps:
        kept = sum(r[f"kept_pos_{cap}"] for r in rows)
        trunc = sum(1 for r in rows if r[f"trunc_{cap}"] > 0)
        lines.append(f"cap={cap}: scenes truncated {trunc}/{n}, "
                     f"positive-pool recall {kept}/{tot} = "
                     f"{kept / max(tot, 1):.3f} (appended GTs always kept)")
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    caps = [int(c) for c in args.caps.split(",")]
    full_float32()
    cfg = load_config(args.config)
    device = mesh.local_device(args.device)
    ds = KittiDataset(cfg, os.path.join(cfg.data.root, "training"),
                      os.path.join(cfg.data.root, "ImageSets", "train.txt"),
                      train=True)
    model = Detector(cfg)
    checkpoint.restore(args.checkpoint, model)
    model.to(device)
    t0 = time.time()
    res = probe(cfg, model, ds, caps, args.scenes, device,
                report=lambda r: print(r, flush=True))
    for line in summary([r for r, _, _ in res], caps, time.time() - t0):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
