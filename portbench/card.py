"""The card a run measures: it must be there (no fallback to the CPU), and
every result names it."""

from __future__ import annotations

import subprocess
import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "stylish_tts_tpu")


class NoCard(RuntimeError):
    pass


def require(chips: int):
    """The first CUDA device, after checking that ``chips`` are present."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("CUDA is not available: the benchmark runs on the card "
                     "only")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} cards, "
                     f"{torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def power_limit() -> str:
    """The card's power limit as nvidia-smi reads it, or "unknown"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
        return out[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def describe(chips: int, peak_bytes: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak_bytes),
            "power_limit": power_limit()}


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is JAX's, flax's or the JAX package's."""
    names = list(sys.modules) if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
