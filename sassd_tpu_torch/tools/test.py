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

Across processes (``--dist`` under torchrun, or ``--coordinator host:port
--num_processes N --process_id R``), each data row of ranks
(parallel/mesh.py: every rank under the data strategy, ``parallel.spatial``
ranks under "spatial" and "banded") runs its strided share of the split,
its first rank writes that share's result files, and rank 0 prints the AP
over one copy of each row's detections (gathered through
``{work_dir}/eval_exchange``).
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
    ap.add_argument("--dist", action="store_true",
                    help="join the process group from torchrun's "
                         "environment (MASTER_ADDR/PORT, RANK, WORLD_SIZE)")
    ap.add_argument("--coordinator", default=None,
                    help="rank 0's host:port (with --num_processes and "
                         "--process_id)")
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
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
    if args.dist or args.coordinator:
        dist.initialize(args.coordinator, args.num_processes,
                        args.process_id, device=device)
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
        lay = mesh.layout(cfg)
        annos, ids = run_inference(cfg, dataset, model, args.batch_size,
                                   device, num_shards=lay.data,
                                   shard_id=lay.data_index)
        if lay.spatial_index == 0:      # the row's other ranks hold copies
            write_result_files(annos, ids, args.out)
            logger.info("wrote %d result files to %s", len(ids), args.out)
        precomputed = (annos, ids)
    _, text = evaluate(cfg, dataset, model,
                       os.path.join(data_root, "label_2"), args.batch_size,
                       device, precomputed=precomputed,
                       exchange_dir=os.path.join(cfg.work_dir,
                                                 "eval_exchange"))
    if dist.is_primary():
        print(text)
    dist.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
