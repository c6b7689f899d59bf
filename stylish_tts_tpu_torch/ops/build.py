"""Build the port's CUDA sources into plain-C shared libraries.

``csrc/<stem>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``build/lib<stem>-<hash>.so`` inside the package (the hash is the source's,
so an edited source rebuilds) and is loaded with ``ctypes``.  Nothing is
built at import: the first launch of a kernel builds its library.  The
compiler's register and spill report lands in ``build/<stem>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

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


def load_library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built first if stale.
    Raises with the compiler's output if the build fails."""
    if stem not in _loaded:
        target = _target(stem)
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            done = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC_DIR / f"{stem}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            (BUILD_DIR / f"{stem}.log").write_text(done.stdout)
            if done.returncode != 0:
                raise RuntimeError(f"nvcc failed for {stem}:\n"
                                   f"{done.stdout[-4000:]}")
            os.replace(tmp, target)
        _loaded[stem] = ctypes.CDLL(str(target))
    return _loaded[stem]
