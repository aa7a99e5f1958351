"""Build-on-first-use of the port's shared libraries.

Each library is compiled from sources in the checkout into
``sassd_tpu_torch/_build/`` (listed in .gitignore). The file name carries a
hash of the sources and the compiler command, so an edited source is
rebuilt and never silently replaced by an older binary. Concurrent builds
(parallel test workers) each write a private temporary file and rename it
into place, which is atomic.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path
from typing import Sequence

PKG_DIR = Path(__file__).resolve().parents[1]
REPO_DIR = PKG_DIR.parent
BUILD_DIR = PKG_DIR / "_build"


# compiler output of the builds made by this process (ptxas -v reports)
BUILD_LOG: dict = {}


class BuildError(RuntimeError):
    pass


def build_shared(name: str, sources: Sequence[Path], command: Sequence[str],
                 timeout: float = 600.0) -> Path:
    """Compile `sources` with `command + [-o out] + sources` unless built.

    Returns the path of the shared library. Raises BuildError with the
    compiler's output if the build fails.
    """
    h = hashlib.sha256(" ".join(command).encode())
    for src in sources:
        h.update(Path(src).read_bytes())
    out = BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = list(command) + ["-o", str(tmp)] + [str(s) for s in sources]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=timeout)
    except FileNotFoundError as e:
        raise BuildError(f"{name}: compiler not found: {cmd[0]}") from e
    if res.returncode != 0 or not tmp.exists():
        raise BuildError(f"{name}: build failed ({' '.join(cmd)}):\n"
                         f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    BUILD_LOG[name] = res.stdout + res.stderr
    return out
