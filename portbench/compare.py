"""The numbers that decide ``correct``, each the same function of the
program's readings and the reference's, and the control's precision.

Training (the check steps from the same weights, batches and generator):

- ``loss_gap``: the relative gap of the first step's total loss;
- ``pitch_gap``: the same of its pitch term (the pitch-energy predictor's
  F0 against the target), the term whose gap bf16 keeps smallest against
  float8's; read only where the stage has a pitch term;
- ``grad_gap``: of each parameter tensor (leaf), the norm of its first
  gradient as AdamW got it (its first moment after one step over
  1 - beta1); the gap between the two norms over the larger of the
  reference's norm of that leaf and of the median leaf; the median over
  the leaves;
- ``change_gap``: the same of the norm of each leaf's change over the
  check steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (the others move by round-off alone
  under Adam's normalised update);
- ``grad_gap.<model>`` and ``worst_grad_gap.<model>``: the first-gradient
  gap of the median and of the worst leaf of one trained model, each
  leaf's gap over the larger of its reference norm and the model's median
  leaf's (``mrd``: these see the MRD's weight gradients, 54 of some 900
  leaves, which the median over all leaves cannot);
- ``norm_gap.<model>``: the relative gap of the norm of one model's whole
  first gradient (all its leaves together).

A cell's limits file names the numbers it compares; a number it names and
the run did not read fails.

The worst leaf's gaps and the gap of every step's loss are read too, and
not compared: in bf16 they read 0.2-0.45 and up to 1.2e-3 on every seed,
as far as the float8 control does (see PERF.md: the sums of bf16 gradients
over many positions that cancel, and the later steps' trajectories that
part after Adam's first update).

Synthesis: ``pcm_gap``, the worst utterance's RMS gap of its int16 PCM
over the reference's RMS.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

QUIET_GRAD = 1e-3  # of the median leaf's gradient norm


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves=None) -> Dict[str, float]:
    """Each leaf's gap (all of ``ref``'s, or ``leaves``); NaN reads inf."""
    median = statistics.median(ref.values())
    out = {}
    for leaf in (ref if leaves is None else leaves):
        gap = abs(prog[leaf] - ref[leaf]) / max(ref[leaf], median, 1e-30)
        out[leaf] = math.inf if math.isnan(gap) else gap
    return out


def moving_leaves(ref_grad: Dict[str, float]) -> List[str]:
    median = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= QUIET_GRAD * median]


def _median_and_worst(gaps: Dict[str, float]) -> tuple:
    worst = max(gaps, key=gaps.get)
    return statistics.median(gaps.values()), worst, gaps[worst]


def models_of(leaves) -> List[str]:
    """The trained models, in order, of leaves named ``model.name``."""
    return list(dict.fromkeys(leaf.split(".", 1)[0] for leaf in leaves))


def train_numbers(prog: dict, ref: dict) -> Dict[str, Tuple[float, str]]:
    """The numbers of a train cell, each with where it was read (a cell's
    limits file names those it compares)."""
    grad, _, _ = _median_and_worst(leaf_gaps(prog["grad"], ref["grad"]))
    change, _, _ = _median_and_worst(leaf_gaps(
        prog["change"], ref["change"], moving_leaves(ref["grad"])))
    first_p, first_r = prog["metrics"][0], ref["metrics"][0]
    out = {"loss_gap": (loss_gap(prog["loss"][:1], ref["loss"][:1]),
                        "first step's total loss"),
           "grad_gap": (grad, "median leaf"),
           "change_gap": (change, "median moving leaf")}
    if "pitch" in first_p and "pitch" in first_r:
        out["pitch_gap"] = (loss_gap([first_p["pitch"]], [first_r["pitch"]]),
                            "first step's pitch loss")
    for model in models_of(ref["grad"]):
        own = {k: v for k, v in ref["grad"].items()
               if k.split(".", 1)[0] == model}
        median, leaf, worst = _median_and_worst(
            leaf_gaps(prog["grad"], own))
        out[f"grad_gap.{model}"] = (median, f"median leaf of {model}")
        out[f"worst_grad_gap.{model}"] = (worst, leaf)
        whole = [math.hypot(*[d[k] for k in own]) for d in (prog["grad"],
                                                             own)]
        out[f"norm_gap.{model}"] = (loss_gap(whole[:1], whole[1:]),
                                    f"all leaves of {model}")
    return out


def train_details(prog: dict, ref: dict) -> dict:
    """What is read and not compared: the worst leaves, every step's
    loss."""
    _, g_leaf, g = _median_and_worst(leaf_gaps(prog["grad"], ref["grad"]))
    _, c_leaf, c = _median_and_worst(leaf_gaps(
        prog["change"], ref["change"], moving_leaves(ref["grad"])))
    return {"loss_gap_all_steps": loss_gap(prog["loss"], ref["loss"]),
            "worst_grad_gap": g, "worst_grad_leaf": g_leaf,
            "worst_change_gap": c, "worst_change_leaf": c_leaf}


def pcm_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    p, r = prog.astype(np.float64), ref.astype(np.float64)
    if p.shape != r.shape:
        return math.inf
    return float(np.sqrt(np.mean((p - r) ** 2))
                 / max(np.sqrt(np.mean(r ** 2)), 1e-30))


def _rounded(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to the float8 ``dtype`` at a per-tensor scale (its
    largest magnitude at the type's largest), back in ``t``'s type."""
    top = torch.finfo(dtype).max
    scale = top / t.abs().amax().float().clamp(min=1e-30)
    return ((t.float() * scale).to(dtype).float() / scale).to(t.dtype)


class _Fp8(torch.autograd.Function):
    """float8 as fp8 training runs it: e4m3 forward, e5m2 gradients."""

    @staticmethod
    def forward(ctx, t):
        return _rounded(t, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, grad):
        return _rounded(grad, torch.float8_e5m2)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float8 (e4m3, per-tensor scale) and its gradient too
    (e5m2), as the program's bf16 casts round both ways."""
    return _Fp8.apply(t)
