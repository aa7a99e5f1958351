"""sassd_tpu_torch: the PyTorch/CUDA port of sassd_tpu's inference path.

Subpackages mirror sassd_tpu's module names:
  core      box decoding, anchors, rotated IoU and NMS (kernel K2)
  ops       host library binding, voxelization, sparse conv, PSWarp
            sampling (kernel K3), rotated overlap (kernel K1), CUDA build
  models    VxNet / BEVNet / SSD head / PSWarp head / detector
  data      host input pipeline and synthetic scenes
The hand-written CUDA kernels live in csrc/ and are built with nvcc at
their first launch; on CPU tensors every kernel wrapper runs its plain
PyTorch version.
"""

from sassd_tpu_torch.config import (SASSDConfig, car_config,  # noqa: F401
                                    tiny_config)
