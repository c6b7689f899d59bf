"""Conditional flow matching: the Euler sampler and the OT-CFM training
pair, with model-guidance CFG (the guided target adds w times the
detached difference of the conditional and unconditional velocities).

The random draws (t, z, the condition-drop uniforms) come from an explicit
``torch.Generator`` or are handed in (``draws``), so a test can feed both
frameworks the same ones.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch


def sinusoidal_pos_emb(x: torch.Tensor, dim: int, scale: float = 1000.0
                       ) -> torch.Tensor:
    """[B] timesteps -> [B, dim]: sin | cos at exp-spaced frequencies."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) / (half - 1) * torch.arange(
        half, dtype=torch.float32, device=x.device))
    emb = scale * x[:, None] * freqs[None, :]
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


class CfmSampler:
    """Wraps an estimator ``fn(x, t, **conds) -> velocity``."""

    def __init__(self, estimator: Callable, guidance_w: float = 0.7,
                 cond_drop_prob: float = 0.0,
                 non_drop_conds: Sequence[str] = (),
                 sigma_min: float = 1e-4):
        self.estimator = estimator
        self.guidance_w = guidance_w
        self.cond_drop_prob = cond_drop_prob
        self.non_drop_conds = set(non_drop_conds)
        self.sigma_min = sigma_min

    def sample(self, z: torch.Tensor, n_timesteps: int,
               temperature: float = 1.0, **conds) -> torch.Tensor:
        """Euler-solve the ODE from noise ``z`` over a linear t-span."""
        x = z * temperature
        dt = 1.0 / n_timesteps
        for i in range(n_timesteps):
            t = torch.full((x.shape[0],), i * dt, dtype=x.dtype,
                           device=x.device)
            x = x + dt * self.estimator(x, t=t, **conds)
        return x

    def draw(self, x1: torch.Tensor, conds: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None) -> dict:
        """t [B, 1, 1] uniform, z like ``x1`` standard normal, and one
        uniform [B, 1, ...] per droppable condition."""
        b = x1.shape[0]

        def uniform(*shape):
            return torch.rand(shape, generator=generator, dtype=x1.dtype,
                              device=x1.device)

        t = uniform(b, 1, 1)
        z = torch.randn(x1.shape, generator=generator, dtype=x1.dtype,
                        device=x1.device)
        keep = {k: uniform(b, *(1,) * (v.dim() - 1))
                for k, v in conds.items() if k not in self.non_drop_conds}
        return {"t": t, "z": z, "keep": keep}

    def compute_pred_target(self, x1: torch.Tensor, *,
                            generator: Optional[torch.Generator] = None,
                            draws: Optional[dict] = None, **conds):
        """(prediction, target) of the OT-CFM pair for ``x1`` [B, T, C]."""
        if draws is None:
            draws = self.draw(x1, conds, generator)
        t, z = draws["t"], draws["z"]
        y = (1.0 - (1.0 - self.sigma_min) * t) * z + t * x1
        u = x1 - (1.0 - self.sigma_min) * z
        t_flat = t[:, 0, 0]
        if self.guidance_w == 0:
            return self.estimator(y, t=t_flat, **conds), u
        cond_args, uncond_args = {}, {}
        for key, value in conds.items():
            if key in self.non_drop_conds:
                cond_args[key] = uncond_args[key] = value
            else:
                keep = draws["keep"][key] > self.cond_drop_prob
                cond_args[key] = value * keep
                uncond_args[key] = torch.zeros_like(value)
        v_cond = self.estimator(y, t=t_flat, **cond_args)
        v_uncond = self.estimator(y, t=t_flat, **uncond_args)
        return v_cond + self.guidance_w * (v_cond - v_uncond).detach(), u
