"""Bird's-eye view of a scan, its GT boxes and a checkpoint's detections,
written headless as a PNG (matplotlib, Agg).

    python -m sassd_tpu_torch.tools.visualize configs/car.py \\
        --scan x.bin --ckpt model.pt [--out viz/] [--device cpu]
    python -m sassd_tpu_torch.tools.visualize configs/car.py --synthetic \\
        --ckpt model.msgpack --out viz/

Without ``--scan`` (or with ``--synthetic``) the scan is the synthetic
scene of seed 0, drawn with its GT boxes (green); a raw ``.bin`` scan has
none. With ``--ckpt`` (the port's ``.pt`` or a JAX ``.msgpack``; its
parameters are loaded, BatchNorm statistics keep their initial values)
the detector runs on the scan and its detections are drawn (red). The
picture is ``{out}/bev.png``.

The work is in three parts: :func:`scene` (the points, GT boxes and
detections), :func:`bev_polylines` (what is drawn) and :func:`render`
(matplotlib, imported there only).
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from sassd_tpu_torch.config import load_config
from sassd_tpu_torch.data import calib, kitti, synthetic
from sassd_tpu_torch.data.augment import corners_2d
from sassd_tpu_torch.inference import make_test_step
from sassd_tpu_torch.models.detector import Detector
from sassd_tpu_torch.ops.voxelize import voxelize_np
from sassd_tpu_torch.parallel import mesh
from sassd_tpu_torch.tools import full_float32
from sassd_tpu_torch.train import checkpoint

GT_COLOR = "#2a9d2a"
DET_COLOR = "#d62728"


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="BEV picture of a scan, its GT "
                                 "boxes and detections (PyTorch port)")
    ap.add_argument("config")
    ap.add_argument("--scan", default=None, help="velodyne .bin file")
    ap.add_argument("--ckpt", default=None,
                    help=".pt or JAX .msgpack checkpoint")
    ap.add_argument("--synthetic", action="store_true",
                    help="draw the synthetic scene of seed 0")
    ap.add_argument("--out", default="viz")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def scene(cfg, scan: Optional[str] = None, ckpt: Optional[str] = None,
          device="cuda") -> Tuple[np.ndarray, Optional[np.ndarray],
                                  Optional[Dict[str, np.ndarray]]]:
    """(points [N, 4], GT boxes [G, 7] or None, detections or None).

    The scan is the synthetic scene of seed 0 (with its GT boxes) when
    `scan` is None, else the raw ``.bin`` file (no GT). With `ckpt` the
    detector runs on it on `device`: host voxels and plans, every anchor
    unmasked, no GT slots; the detections are the valid ones, a dict of
    numpy ``boxes`` [D, 7], ``scores`` [D] and ``labels`` [D].
    """
    if scan is None:
        points, boxes, _ = synthetic.make_scene(np.random.default_rng(0))
    else:
        points, boxes = calib.read_lidar(scan), None
    if not ckpt:
        return points, boxes, None
    model = Detector(cfg)
    checkpoint.load_params_only(ckpt, model)
    model.to(device)
    v, c, n = voxelize_np(points, cfg.voxel, pad=True)
    g = cfg.caps.max_gt
    batch = dict(voxels=v[None], num_points=n[None], coords=c[None],
                 anchors_mask=np.ones((1, cfg.num_anchors), bool),
                 gt_boxes=np.zeros((1, g, 7), np.float32),
                 gt_classes=np.zeros((1, g), np.int32),
                 gt_valid=np.zeros((1, g), bool))
    batch.update({k: a[None] for k, a in
                  kitti.build_host_plans(cfg, c).items()})
    anchors = kitti.build_anchors(cfg)[0]
    out = make_test_step(cfg, anchors, device)(model, batch)
    keep = out["valid"][0].cpu().numpy()
    dets = {k: out[k][0].cpu().numpy()[keep]
            for k in ("boxes", "scores", "labels")}
    return points, boxes, dets


def _rings(boxes: Optional[np.ndarray]) -> List[np.ndarray]:
    if boxes is None or len(boxes) == 0:
        return []
    cs = corners_2d(boxes[:, :2], boxes[:, 3:5], boxes[:, 6])
    return [np.concatenate([c, c[:1]]) for c in cs]


def bev_polylines(cfg, gt_boxes: Optional[np.ndarray],
                  det_boxes: Optional[np.ndarray]) -> Dict:
    """What the picture draws: each box's BEV outline as a closed ring
    [5, 2] (corner 0 repeated), GT and detections apart, and the axis
    limits (xmin, xmax, ymin, ymax) of the config's point-cloud range."""
    pcr = cfg.voxel.point_cloud_range
    return dict(gt=_rings(gt_boxes), dets=_rings(det_boxes),
                xlim=(pcr[0], pcr[3]), ylim=(pcr[1], pcr[4]))


def render(path: str, points: np.ndarray, lines: Dict) -> None:
    """Draw the points (grey) and the rings of :func:`bev_polylines` into
    a PNG at `path` (matplotlib's Agg backend)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(14, 16), dpi=120)
    ax.scatter(points[:, 0], points[:, 1], s=0.05, c="#888888",
               linewidths=0)
    for key, color in (("gt", GT_COLOR), ("dets", DET_COLOR)):
        for ring in lines[key]:
            ax.plot(ring[:, 0], ring[:, 1], color=color, linewidth=0.8)
    ax.set_xlim(*lines["xlim"])
    ax.set_ylim(*lines["ylim"])
    ax.set_aspect("equal")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    full_float32()
    cfg = load_config(args.config)
    device = mesh.local_device(args.device)
    scan = None if args.synthetic else args.scan
    points, boxes, dets = scene(cfg, scan, args.ckpt, device)
    lines = bev_polylines(cfg, boxes, None if dets is None
                          else dets["boxes"])
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "bev.png")
    render(path, points, lines)
    print("wrote", path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
