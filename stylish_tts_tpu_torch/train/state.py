"""The train state: the models (f32 master parameters, and the batch
stats as their buffers), one optimizer per module, the discriminator-loss
EMA and the step within the stage.

The step updates the state in place: parameters, optimizer moments and
batch stats are overwritten rather than copied, which keeps one copy of
each on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch
from torch import nn


@dataclass
class TrainState:
    models: Dict[str, nn.Module]
    optimizers: Dict[str, torch.optim.AdamW]
    disc_ema: Dict[str, torch.Tensor]  # per-discriminator plain-loss EMA
    step: int = 0
