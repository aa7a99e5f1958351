"""The hand-written CUDA kernels: build, load, launch, count.

All ``csrc/*.cu`` sources are compiled by ``nvcc`` at first use (never at
import), one compiler per source, all started together, and linked into
one shared library with a plain C interface, bound with ctypes. Each C
entry point launches on the stream it is given and returns
``cudaGetLastError()``; :meth:`Kernel.launch` raises on a nonzero code and
counts the launch.
"""
from __future__ import annotations

import ctypes
import os
import shutil
from typing import Optional, Sequence

import torch

from .build import PKG_DIR, build_shared

SOURCES = sorted((PKG_DIR / "csrc").glob("*.cu"))
# No --use_fast_math: the rotated-overlap tie-breaks need IEEE sin/cos and
# division. -fmad=false keeps every product rounded as in the plain
# PyTorch versions the kernels are checked against; a kernel that wants
# fused multiply-adds (K4) writes __fmaf_rn.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = ["-shared"]
_lib: Optional[ctypes.CDLL] = None
# every Kernel by symbol, so a run can reset and read the launch counts
KERNELS: dict = {}

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    return path if os.path.exists(path) else (shutil.which("nvcc") or "nvcc")


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    global _lib
    if _lib is None:
        path = build_shared("sassd_kernels", SOURCES, [nvcc()] + NVCC_FLAGS,
                            [nvcc()] + LINK_FLAGS)
        lib = ctypes.CDLL(str(path))
        lib.sassd_cuda_error_string.restype = ctypes.c_char_p
        lib.sassd_cuda_error_string.argtypes = [I]
        _lib = lib
    return _lib


class Kernel:
    """One C entry point of the kernel library and its launch count."""

    def __init__(self, symbol: str, argtypes: Sequence):
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        KERNELS[symbol] = self

    def launch(self, *args) -> None:
        if self._fn is None:
            lib = load()
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes + [P]
            fn.restype = I
            self._fn = fn
        # the current stream's handle, without building a Stream object
        stream = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
        err = self._fn(*args, stream)
        if err != 0:
            msg = load().sassd_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err}: {msg}")
        self.launches += 1


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
               ndim: int, contiguous: bool = True) -> None:
    """Raise unless `t` is a CUDA tensor of the given dtype and rank."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtypes, shapes and bit patterns (-0.0 is not 0.0): how a
    kernel's result is held against its plain version's, on any devices."""
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)
