"""Warm-start a train state from a torch reference checkpoint (CLI
``train --init-torch``).

Every model of the state that the checkpoint holds and that has a
converter (``models/torch_convert.py``) gets the converted weights in its
f32 masters and buffers, in place: the aligner's batch-norm ``mean``/``var``
and the mel style encoder's spectral-norm ``u``/``sigma`` with the
parameters.  Optimizers, the LR schedule, the CTC priors and the run's
generator start fresh.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Union

import torch

from ..convert import load_flax_params
from ..export.import_torch import load_reference_state_dicts
from ..models.torch_convert import CONVERTERS, convert_module
from .state import TrainState

logger = logging.getLogger(__name__)


@torch.no_grad()
def seed_state_from_torch(state: TrainState,
                          checkpoint_dir: Union[str, Path]) -> TrainState:
    """``state`` with the weights of the reference checkpoint at
    ``checkpoint_dir``; a model without a converter, or not in the state,
    is skipped with a log line.  A tensor that does not fit raises."""
    for name, sd in load_reference_state_dicts(checkpoint_dir).items():
        if name not in CONVERTERS or name not in state.models:
            logger.info("init-torch: skipping %s (%s)", name,
                        "no converter" if name not in CONVERTERS
                        else "not in the state")
            continue
        params, stats = convert_module(name, sd)
        module = state.models[name]
        module.load_state_dict(load_flax_params(name, {**params, **stats},
                                                module))
        logger.info("init-torch: imported %s", name)
    return state
