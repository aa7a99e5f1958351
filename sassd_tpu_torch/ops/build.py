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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Sequence

PKG_DIR = Path(__file__).resolve().parents[1]
REPO_DIR = PKG_DIR.parent
BUILD_DIR = PKG_DIR / "_build"


# compiler output of the builds made by this process (ptxas -v reports)
BUILD_LOG: dict = {}


class BuildError(RuntimeError):
    pass


def _run(name: str, cmd: Sequence[str], timeout: float) -> str:
    """Run one compiler command; its output, or BuildError."""
    try:
        res = subprocess.run(list(cmd), capture_output=True, text=True,
                             timeout=timeout)
    except FileNotFoundError as e:
        raise BuildError(f"{name}: compiler not found: {cmd[0]}") from e
    if res.returncode != 0:
        raise BuildError(f"{name}: build failed ({' '.join(cmd)}):\n"
                         f"{res.stdout}\n{res.stderr}")
    return res.stdout + res.stderr


def build_shared(name: str, sources: Sequence[Path],
                 compile_cmd: Sequence[str], link_cmd: Sequence[str],
                 timeout: float = 600.0) -> Path:
    """Build a shared library from `sources` unless it is built.

    Every source is compiled on its own (``compile_cmd + [-c, -o obj, src]``),
    all compilers started together, and ``link_cmd + [-o out] + objects``
    joins the objects. Returns the path of the library. Raises BuildError
    with the compiler's output on failure.
    """
    h = hashlib.sha256(" ".join(compile_cmd).encode())
    h.update(" ".join(link_cmd).encode())
    for src in sources:
        h.update(Path(src).read_bytes())
    out = BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_suffix(f".{i}.o") for i in range(len(sources))]
    cmds = [list(compile_cmd) + ["-c", "-o", str(o), str(s)]
            for o, s in zip(objs, sources)]
    with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
        logs = [f.result() for f in
                [pool.submit(_run, name, c, timeout) for c in cmds]]
    log = "".join(logs) + _run(
        name, list(link_cmd) + ["-o", str(tmp)] + [str(o) for o in objs],
        timeout)
    for o in objs:
        o.unlink()
    if not tmp.exists():
        raise BuildError(f"{name}: the build wrote no {tmp.name}:\n{log}")
    os.replace(tmp, out)
    BUILD_LOG[name] = log
    return out
