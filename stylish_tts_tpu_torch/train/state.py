"""The train state: the models (f32 master parameters, and the batch
stats as their buffers), one optimizer per module, the discriminator-loss
EMA, the CTC label priors of the alignment stage and the step within the
stage.

The step updates the state in place: parameters, optimizer moments and
batch stats are overwritten rather than copied, which keeps one copy of
each on the card.  So a copy that must survive a step (the OOM guard's
first-visit snapshot, the memory probe) is taken with ``snapshot_state``
and written back, tensor by tensor, with ``restore_state``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch import nn


@dataclass
class TrainState:
    models: Dict[str, nn.Module]
    optimizers: Dict[str, torch.optim.AdamW]
    disc_ema: Dict[str, torch.Tensor]  # per-discriminator plain-loss EMA
    # the CTC label priors [C] (C = tokens + 1) and this epoch's
    # accumulators: the log-sum of the emissions [C] and the frame count
    priors: Dict[str, torch.Tensor] = field(default_factory=dict)
    step: int = 0


def init_priors(n_classes: int, device=None) -> Dict[str, torch.Tensor]:
    """The prior state before the first epoch's end: flat priors, empty
    accumulators, ``priors_initialized`` false."""
    return {
        "log_priors": torch.zeros(n_classes, device=device),
        "prior_sum": torch.full((n_classes,), -1e30, device=device),
        "prior_frames": torch.zeros((), device=device),
        "priors_initialized": torch.zeros((), dtype=torch.bool,
                                          device=device),
    }


def _params(optimizer: torch.optim.Optimizer):
    return [p for group in optimizer.param_groups for p in group["params"]]


def snapshot_state(state: TrainState,
                   generator: Optional[torch.Generator] = None) -> dict:
    """Host copies of every parameter, buffer, optimizer moment
    (by the parameter's place in its optimizer; a parameter without
    moments is recorded as such), the EMA, the priors, the step and the
    generator's state."""
    def copy(t):
        return t.detach().to("cpu", copy=True)

    return {
        "models": {k: {n: copy(t) for n, t in m.state_dict().items()}
                   for k, m in state.models.items()},
        # each moment with the device it lives on (AdamW keeps its step
        # count on the host)
        "optimizers": {
            k: [{n: (copy(v), v.device) if torch.is_tensor(v) else v
                 for n, v in o.state[p].items()} if p in o.state else None
                for p in _params(o)]
            for k, o in state.optimizers.items()},
        "disc_ema": {k: copy(v) for k, v in state.disc_ema.items()},
        "priors": {k: copy(v) for k, v in state.priors.items()},
        "step": state.step,
        "generator": None if generator is None else generator.get_state(),
    }


@torch.no_grad()
def restore_state(state: TrainState, snapshot: dict,
                  generator: Optional[torch.Generator] = None) -> None:
    """Write ``snapshot`` back into ``state`` (and ``generator``) in place:
    afterwards every tensor equals the snapshot's, moments created since
    are dropped and every gradient is cleared."""
    for key, module in state.models.items():
        saved = snapshot["models"][key]
        for name, tensor in module.state_dict().items():
            tensor.copy_(saved[name])
    for key, optimizer in state.optimizers.items():
        for p, saved in zip(_params(optimizer), snapshot["optimizers"][key]):
            p.grad = None
            if saved is None:
                optimizer.state.pop(p, None)
                continue
            current = optimizer.state.get(p)
            if current is not None and current.keys() == saved.keys():
                for name, value in saved.items():
                    if isinstance(value, tuple):
                        current[name].copy_(value[0])
                    else:
                        current[name] = value
            else:
                optimizer.state[p] = {
                    n: v[0].to(v[1], copy=True) if isinstance(v, tuple)
                    else v for n, v in saved.items()}
    for key, value in snapshot["disc_ema"].items():
        state.disc_ema[key] = value.to(state.disc_ema[key].device, copy=True)
    for key, value in snapshot["priors"].items():
        state.priors[key] = value.to(state.priors[key].device, copy=True)
    state.step = snapshot["step"]
    if generator is not None and snapshot["generator"] is not None:
        generator.set_state(snapshot["generator"])
