"""sassd_tpu_torch: the PyTorch/CUDA port of sassd_tpu's inference path.

Subpackages and modules mirror sassd_tpu's names:
  core      box decoding, anchors, rotated IoU and NMS (kernel K2), the
            evaluator's numpy overlaps
  ops       host library binding, voxelization (kernel K8), sparse conv
            and the device rulebook (K4-K7), PSWarp sampling (K3), rotated
            overlap (K1), CUDA build
  models    VxNet / BEVNet / SSD head / PSWarp head / detector
  parallel  data-parallel process groups (dist, mesh: SyncBN, the
            gradient all-reduce, the evaluation gather) and the banded
            sparse stage (band partition, K16)
  data      KITTI and raw-scan datasets, loader, synthetic scenes
  eval      KITTI result files and the official AP evaluation
  serve     device-resident serving from raw points (anchors mask, K9)
  inference test steps, run_inference, evaluate (sharded over ranks)
The hand-written CUDA kernels live in csrc/ and are built with nvcc at
their first launch; on CPU tensors every kernel wrapper runs its plain
PyTorch version.
"""

from sassd_tpu_torch.config import (SASSDConfig, car_config,  # noqa: F401
                                    tiny_config)
