"""The port's tracing, ``span(name)``, and the run's git state beside its
outputs (reference train/utils.py:308-338).

``span`` names a stretch of host work: ``with span("train.backward"):``.
Tracing is on exactly when a ``torch.profiler.profile`` session records;
there is no other switch, store or exporter.  Off, a span costs one check
of the profiler's flag and enters nothing.  On, it is a
``torch.profiler.record_function`` range: a ``user_annotation`` event on
the profiler's own clock, nested under the span that encloses it on the
host thread, and mirrored by Kineto on the device timeline, in the same
trace as every kernel.  The train step (``train/stages.py``) and batch
synthesis (``export/infer.py``) carry spans at their layer boundaries.

To trace a step, wrap it in a profiler and open its Chrome trace in
Perfetto (ui.perfetto.dev) or chrome://tracing::

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, metrics = step(state, batch, generator)
        torch.cuda.synchronize()
    prof.export_chrome_trace("step.json")
"""

from __future__ import annotations

import contextlib
import subprocess
from pathlib import Path
from typing import Union

import torch
from torch.profiler import record_function

# the checkout the package sits in: where ``save_git_state`` asks git
CHECKOUT = Path(__file__).resolve().parents[2]

# whether a profiler session records on this process
_recording = torch._C._autograd._profiler_enabled
# reusable: a nullcontext holds no state
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager naming the block ``name`` in a profiler's trace:
    ``record_function(name)`` while a profiler records, else a shared
    no-op context."""
    return record_function(name) if _recording() else _OFF


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
