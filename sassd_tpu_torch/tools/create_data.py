"""Offline KITTI data preparation CLI:

    python -m sassd_tpu_torch.tools.create_data /path/to/KITTI --all
    python -m sassd_tpu_torch.tools.create_data /path/to/KITTI --infos \\
        --reduced --gt_db [--classes Car Pedestrian Cyclist]

The root holds ``training/{velodyne, calib, label_2[, image_2]}`` and
``ImageSets/{train,val}.txt``: ``--reduced`` writes
``training/velodyne_reduced``, ``--infos`` ``kitti_infos_{split}.pkl``,
``--gt_db`` ``gt_database/`` and ``kitti_dbinfos_train.pkl`` (the
config's ``data.db_info_path``).
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="KITTI data preparation")
    ap.add_argument("data_root",
                    help="KITTI root (contains training/, ImageSets/)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--infos", action="store_true")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--gt_db", action="store_true")
    ap.add_argument("--classes", nargs="*", default=None)
    args = ap.parse_args(argv)

    from sassd_tpu_torch.data import create_data as cd
    if args.all or args.reduced:
        cd.create_reduced_point_cloud(args.data_root)
    if args.all or args.infos:
        cd.create_kitti_info_file(args.data_root)
    if args.all or args.gt_db:
        cd.create_groundtruth_database(args.data_root, "train", args.classes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
