"""Command-line entry points of the port, run as modules from the repo
root (``python -m sassd_tpu_torch.tools.<name> ...``):

  train                        train a detector from a config file
  test                         evaluate a checkpoint (.pt or JAX .msgpack)
  create_data                  info files, reduced scans, GT database
  make_synth_corpus            a synthetic multi-class corpus + GT database
  import_reference_checkpoint  a reference SA-SSD .pth -> a port .pt
  visualize                    a BEV picture of a scan, GT and detections
  sweep_guided                 the PSWarp candidate cap's positive recall

They take the flags of the JAX package's ``tools/`` scripts of the same
names, and ``--device`` (default ``cuda``; ``cpu`` runs the plain
versions of the kernels).
"""


def full_float32() -> None:
    """Run the card's float32 convolutions and matmuls in full float32
    (PyTorch lets cuDNN use TF32 by default): model.compute_dtype
    "float32" asks for it, and under "bfloat16" the float32 parts (the
    head, the VFEs, the aux branch, the tail's 1x1x1 conv) stay float32
    as in the JAX package. TF32 is a setting the JAX package lacks."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
