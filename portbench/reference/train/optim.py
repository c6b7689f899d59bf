"""One AdamW per module, the logical-axis cosine schedule and the LR
setting of each step.

Each module key has its own ``torch.optim.AdamW`` (betas (0.85, 0.99), eps
1e-9, weight decay 1e-4, decoupled as optax's ``adamw``).  The train step
sets the learning rate before every update: the generator modules follow
``cosine_logical_lr``; the discriminator takes that LR times the gap-aware
multiplier of its loss EMA.
"""

from __future__ import annotations

import math

import torch
from torch import nn

LOGICAL_STEP_LIMIT = 10_000
PLATEAU = 0.9
BETAS = (0.85, 0.99)
EPS = 1e-9
WEIGHT_DECAY = 1e-4


def cosine_logical_lr(base_lr: float, step: int, step_limit: int) -> float:
    """Cosine decay (no warmup) over a logical 10k-step axis rescaled to
    the stage length, held at its 90 % value after that."""
    logical = step * LOGICAL_STEP_LIMIT // max(step_limit, 1)
    logical = min(logical, int(LOGICAL_STEP_LIMIT * PLATEAU))
    progress = logical / LOGICAL_STEP_LIMIT
    return base_lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * progress)))


def make_optimizer(module: nn.Module) -> torch.optim.AdamW:
    return torch.optim.AdamW(
        [p for p in module.parameters() if p.requires_grad], lr=0.0,
        betas=BETAS, eps=EPS, weight_decay=WEIGHT_DECAY)


def apply_updates(optimizer: torch.optim.AdamW, lr: float) -> None:
    """One AdamW step at ``lr``.  A parameter the loss did not reach gets
    a zero gradient, so it decays as optax's update (zero moments) does."""
    for group in optimizer.param_groups:
        group["lr"] = lr
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    optimizer.step()
