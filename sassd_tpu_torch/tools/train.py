"""Training CLI: load a config file, build the dataset and the detector,
train with one-cycle AdamW, on one device or data-parallel.

    python -m sassd_tpu_torch.tools.train configs/car.py --work_dir runs/car
    python -m sassd_tpu_torch.tools.train configs/tiny.py --synthetic \\
        --device cpu                                  # hermetic smoke run

``--synthetic`` writes a 16 + 4 scan synthetic KITTI split (seeded by the
config's train seed) to ``{work_dir}/synthetic_kitti`` and trains on it.
``--epochs_per_run N`` stops the process after N epochs, the schedule
still spanning ``--epochs``, and exits 75 while epochs remain: an outer
loop relaunches the same command, which resumes from the newest
checkpoint in the work directory. Data-parallel: ``torchrun
--nproc_per_node=N -m sassd_tpu_torch.tools.train ... --dist`` (the group
from torchrun's environment), or one process per rank with
``--coordinator host:port --num_processes N --process_id R``; each rank
runs on ``cuda:{LOCAL_RANK}`` (or the CPU with ``--device cpu``).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import List, Optional

from sassd_tpu_torch.tools import full_float32

EXIT_MORE_EPOCHS = 75


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Train a SA-SSD detector "
                                 "(PyTorch port)")
    ap.add_argument("config", help="python config file defining `config`")
    ap.add_argument("--work_dir", default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--resume_from", default=None)
    ap.add_argument("--load_from", default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--synthetic", action="store_true",
                    help="train on generated synthetic scenes (no KITTI)")
    ap.add_argument("--eval_interval", type=int, default=None,
                    help="run val evaluation every N epochs")
    ap.add_argument("--epochs_per_run", type=int, default=None,
                    help="bound THIS process to N epochs (the schedule "
                         "stays pinned to --epochs); exits 75 while more "
                         "epochs remain, for an outer loop to relaunch")
    ap.add_argument("--dist", action="store_true",
                    help="join the process group from torchrun's "
                         "environment (MASTER_ADDR/PORT, RANK, WORLD_SIZE)")
    ap.add_argument("--coordinator", default=None,
                    help="rank 0's host:port (with --num_processes and "
                         "--process_id)")
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; cuda:{LOCAL_RANK} per rank) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    full_float32()
    from sassd_tpu_torch.config import load_config
    from sassd_tpu_torch.data.kitti import KittiDataset
    from sassd_tpu_torch.data.synthetic import write_synthetic_kitti
    from sassd_tpu_torch.parallel import dist, mesh
    from sassd_tpu_torch.train.loop import train_model
    from sassd_tpu_torch.utils.logging_utils import get_root_logger

    device = mesh.local_device(args.device)
    if args.dist or args.coordinator:
        dist.initialize(args.coordinator, args.num_processes,
                        args.process_id, device=device)
    cfg = load_config(args.config)
    updates = {k: getattr(args, k) for k in ("work_dir", "resume_from",
                                             "load_from") if getattr(args, k)}
    if args.seed is not None:
        updates["train"] = dataclasses.replace(cfg.train, seed=args.seed)
    cfg = dataclasses.replace(cfg, **updates)

    logger = get_root_logger(cfg.work_dir)
    logger.info("device %s, rank %d of %d", device, dist.process_index(),
                dist.process_count())
    if args.synthetic:
        root = os.path.join(cfg.work_dir, "synthetic_kitti")
        if dist.is_primary():
            write_synthetic_kitti(
                root, n_train=16, n_val=4, seed=cfg.train.seed,
                classes=cfg.class_names,
                point_cloud_range=cfg.voxel.point_cloud_range)
            logger.info("synthetic split written to %s", root)
        dist.barrier("synthetic")
        split = os.path.join(root, "ImageSets", "train.txt")
    else:
        root = cfg.data.root
        split = cfg.data.info_path or os.path.join(root, "ImageSets",
                                                   "train.txt")
    data_root = os.path.join(root, "training")
    dataset = KittiDataset(cfg, data_root, split, train=True)

    epoch_callback = None
    if args.eval_interval:
        from sassd_tpu_torch.inference import evaluate
        val_ds = KittiDataset(cfg, data_root,
                              os.path.join(os.path.dirname(split), "val.txt"))

        def epoch_callback(epoch, model):
            _, text = evaluate(cfg, val_ds, model,
                               os.path.join(data_root, "label_2"),
                               device=device,
                               exchange_dir=os.path.join(cfg.work_dir,
                                                         "eval_exchange"))
            if dist.is_primary():
                logger.info("eval after epoch %d:\n%s", epoch, text)

    _, _, step = train_model(cfg, dataset, total_epochs=args.epochs,
                             device=device, logger=logger,
                             epoch_callback=epoch_callback,
                             eval_interval=args.eval_interval,
                             epochs_per_run=args.epochs_per_run)
    dist.shutdown()
    if args.epochs_per_run is not None:
        total = args.epochs or cfg.train.total_epochs
        spe = max(-(-len(dataset) // cfg.train.batch_size), 1)
        if step < spe * total:
            return EXIT_MORE_EPOCHS   # relaunch to continue
    return 0


if __name__ == "__main__":
    sys.exit(main())
