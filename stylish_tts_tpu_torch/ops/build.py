"""Build the port's CUDA sources into plain-C shared libraries.

``csrc/<stem>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``build/lib<stem>-<hash>.so`` inside the package (the hash is the source's,
so an edited source rebuilds) and is loaded with ``ctypes``.  Nothing is
built at import: the first launch of a kernel builds its library, and
``build`` builds several sources at once, one ``nvcc`` each, started
together.  The compiler's register and spill report lands in
``build/<stem>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _target(stem: str) -> Path:
    digest = hashlib.sha256((CSRC_DIR / f"{stem}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{stem}-{digest.hexdigest()[:12]}.so"


def build_log(stem: str) -> str:
    path = BUILD_DIR / f"{stem}.log"
    return path.read_text() if path.exists() else ""


def build(stems: Iterable[str]) -> None:
    """Build every stale library of ``stems``: one ``nvcc`` per source, all
    started together.  Raises with the compiler's output if a build fails."""
    pending = []
    for stem in dict.fromkeys(stems):
        target = _target(stem)
        if target.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
             str(CSRC_DIR / f"{stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        pending.append((stem, target, tmp, proc))
    failed = []
    for stem, target, tmp, proc in pending:
        output, _ = proc.communicate()
        (BUILD_DIR / f"{stem}.log").write_text(output)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {stem}:\n{output[-4000:]}")
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built first if stale."""
    if stem not in _loaded:
        build([stem])
        _loaded[stem] = ctypes.CDLL(str(_target(stem)))
    return _loaded[stem]
