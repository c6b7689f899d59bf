"""Tracing and timing helpers: a torch.profiler trace written as a Chrome
trace, named ranges that show in it, a per-phase wall-clock timer, and the
run's git state beside its outputs (reference train/utils.py:308-338)."""

from __future__ import annotations

import contextlib
import subprocess
import time
from pathlib import Path
from typing import Dict, Union

import torch
from torch.profiler import ProfilerActivity, profile, record_function

# the checkout the package sits in: where ``save_git_state`` asks git
CHECKOUT = Path(__file__).resolve().parents[2]


@contextlib.contextmanager
def trace(out_path: Union[str, Path]):
    """Profile the block with torch.profiler (the host, and the card where
    CUDA is available) and write it to ``out_path`` as a Chrome trace,
    viewable in Perfetto or chrome://tracing.  Yields the profiler, whose
    ``key_averages()`` tabulates the same events."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out))


@contextlib.contextmanager
def annotate(name: str):
    """A named range that shows in ``trace``'s output."""
    with record_function(name):
        yield


class StepTimer:
    """Wall-clock totals and counts per named phase, on the host's clock:
    a phase that launches work on the card ends before the work does
    unless it synchronizes."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items()):
            n = self.counts[name]
            lines.append(f"{name}: {total / n * 1000:.1f} ms/it ({n} its)")
        return "\n".join(lines)


def _git(*args: str) -> str:
    done = subprocess.run(["git", *args], cwd=CHECKOUT, capture_output=True,
                          text=True, timeout=10)
    if done.returncode != 0:
        raise RuntimeError(done.stderr.strip())
    return done.stdout


def save_git_state(out_dir: Union[str, Path]) -> Path:
    """Write ``out_dir/git_state.txt``: the commit of the package's
    checkout and its working diff ("unknown" outside a git checkout or
    without git).  Returns the file's path."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    try:
        commit, diff = _git("rev-parse", "HEAD").strip(), _git("diff")
    except (OSError, RuntimeError, subprocess.SubprocessError):
        commit, diff = "unknown", ""
    path = out / "git_state.txt"
    path.write_text(f"Git commit hash: {commit}\n\n{diff}")
    return path
