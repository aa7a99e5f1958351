"""Evaluation CLI: run a checkpoint over the val split and print the
official KITTI AP tables (R11 and R40; bbox, bev, 3d, aos).

    python -m sassd_tpu_torch.tools.test configs/car.py \\
        work_dir/checkpoint_epoch_79.pt [--out results/] [--device cpu]

The checkpoint is the port's ``.pt`` (from tools.train or
tools.import_reference_checkpoint) or a JAX ``.msgpack``; its parameters
and BatchNorm statistics are loaded. The split is
``{data.root}/ImageSets/val.txt`` unless ``--split`` names one. ``--out``
writes one KITTI result file per scan from the same inference pass that
the AP is computed from.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from sassd_tpu_torch.tools import full_float32


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Evaluate a SA-SSD detector "
                                 "(PyTorch port)")
    ap.add_argument("config")
    ap.add_argument("checkpoint", help=".pt or JAX .msgpack checkpoint")
    ap.add_argument("--split", default=None, help="val split file")
    ap.add_argument("--batch_size", type=int, default=1)
    ap.add_argument("--out", default=None, help="write result files here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    full_float32()
    from sassd_tpu_torch.config import load_config
    from sassd_tpu_torch.data.kitti import KittiDataset
    from sassd_tpu_torch.eval.results import write_result_files
    from sassd_tpu_torch.inference import evaluate, run_inference
    from sassd_tpu_torch.models.detector import Detector
    from sassd_tpu_torch.parallel import dist, mesh
    from sassd_tpu_torch.train import checkpoint as ckpt
    from sassd_tpu_torch.utils.logging_utils import get_root_logger

    device = mesh.local_device(args.device)
    cfg = load_config(args.config)
    logger = get_root_logger()
    data_root = os.path.join(cfg.data.root, "training")
    split = args.split or os.path.join(cfg.data.root, "ImageSets",
                                       "val.txt")
    dataset = KittiDataset(cfg, data_root, split)
    model = Detector(cfg)
    ckpt.restore(args.checkpoint, model)
    model.to(device)

    precomputed = None
    if args.out:
        # one inference pass: this rank's result files, and the same
        # annotations handed to evaluate for the AP tables
        annos, ids = run_inference(cfg, dataset, model, args.batch_size,
                                   device, num_shards=dist.process_count(),
                                   shard_id=dist.process_index())
        write_result_files(annos, ids, args.out)
        logger.info("wrote %d result files to %s", len(ids), args.out)
        precomputed = (annos, ids)
    _, text = evaluate(cfg, dataset, model,
                       os.path.join(data_root, "label_2"), args.batch_size,
                       device, precomputed=precomputed)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
