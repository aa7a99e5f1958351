"""Write a synthetic multi-class training corpus and its GT database:
train and val scans of three classes at the car range, the info files,
and the GT-paste database of the train split.

    python -m sassd_tpu_torch.tools.make_synth_corpus runs/multi_corpus \\
        --n_train 1600 --n_val 200 --classes Car Pedestrian Cyclist

The output is what ``configs/multi_convergence_r*.py`` read (``data.root``,
``data.db_info_path``); the same seed writes the same files as the JAX
package's ``tools/make_synth_corpus.py``.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="synthetic multi-class corpus")
    ap.add_argument("root")
    ap.add_argument("--n_train", type=int, default=1600)
    ap.add_argument("--n_val", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--classes", nargs="*",
                    default=["Car", "Pedestrian", "Cyclist"])
    args = ap.parse_args(argv)

    from sassd_tpu_torch.config import multi_config
    from sassd_tpu_torch.data import create_data as cd
    from sassd_tpu_torch.data.synthetic import write_synthetic_kitti

    cfg = multi_config()
    t0 = time.time()
    write_synthetic_kitti(args.root, n_train=args.n_train, n_val=args.n_val,
                          seed=args.seed, classes=tuple(args.classes),
                          point_cloud_range=cfg.voxel.point_cloud_range)
    print(f"scenes written in {time.time() - t0:.0f}s", flush=True)
    cd.create_kitti_info_file(args.root)
    print(f"infos done at {time.time() - t0:.0f}s", flush=True)
    cd.create_groundtruth_database(args.root, "train", list(args.classes))
    print(f"gt_db done at {time.time() - t0:.0f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
