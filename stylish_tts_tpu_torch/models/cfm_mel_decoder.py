"""CFM mel decoder: the XUT backbone with sine-source harmonic
conditioning and TREAD token routing.

In training (``self.training``) the TREAD route keeps a fixed count of
tokens, ``length - int(length * tread_dropout)``, through the U backbone:
the first of an argsort of uniforms per sample, gathered and scattered
back; the rest pass around it.  ``draw`` makes the step's random draws
(the route's uniforms, the sine source's noise) once, so the conditional
and unconditional passes of a CFG pair share them, as the JAX package's
two applies with the same rngs do.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .cfm import CfmSampler
from .xut import (AdaLNModulation, TBackbone, TimestepEmbedding, XUTBackbone,
                  mish)


class SineGenerator(nn.Module):
    """F0 [B, T] -> tanh(merge(sine source + UV-gated noise)) [B, T, 1];
    the source carries no gradient, ``merge`` (1 -> 1, no bias) does."""

    def __init__(self, sample_rate: int = 24000, sine_amp: float = 0.1,
                 noise_std: float = 0.003, voiced_threshold: float = 0.0):
        super().__init__()
        self.sample_rate, self.sine_amp = sample_rate, sine_amp
        self.noise_std, self.voiced_threshold = noise_std, voiced_threshold
        self.merge = nn.Linear(1, 1, bias=False)

    def forward(self, f0: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            rad = torch.cumsum(torch.remainder(f0 / self.sample_rate, 1.0),
                               dim=1)
            sine = self.sine_amp * torch.sin(2.0 * math.pi * rad)
            uv = (f0 > self.voiced_threshold).to(f0.dtype)
            amp = uv * self.noise_std + (1.0 - uv) * self.sine_amp / 3.0
            source = (sine * uv + amp * noise)[..., None]
        return torch.tanh(self.merge(source))


class CfmMelDecoder(nn.Module):
    def __init__(self, feat_dim: int = 80, asr_dim: int = 256,
                 spk_dim: int = 10240, hidden_dim: int = 256,
                 emb_dim: int = 256, xut_depth: int = 4, xut_heads: int = 8,
                 xut_enc_blocks: int = 1, xut_dec_blocks: int = 2,
                 tread_prev_depth: int = 1, tread_post_depth: int = 3,
                 tread_dropout: float = 0.5):
        super().__init__()
        self.tread_dropout = tread_dropout
        self.asr_emb1 = nn.Linear(asr_dim, emb_dim * 4)
        self.asr_emb2 = nn.Linear(emb_dim * 4, emb_dim)
        self.spk_emb1 = nn.Linear(spk_dim, emb_dim * 4)
        self.spk_emb2 = nn.Linear(emb_dim * 4, emb_dim)
        self.m_source = SineGenerator()
        self.prior_generator = nn.Conv1d(3, feat_dim, 7, padding=3)
        self.in_proj = nn.Linear(feat_dim + 2 * emb_dim, hidden_dim)
        self.time_emb = TimestepEmbedding(hidden_dim)
        self.shared_attn = AdaLNModulation(hidden_dim)
        self.shared_xattn = AdaLNModulation(hidden_dim)
        self.shared_ffw = AdaLNModulation(hidden_dim)
        mlp = hidden_dim * 4
        self.prev_tread = TBackbone(hidden_dim, xut_heads, mlp,
                                    tread_prev_depth, shared=True)
        self.backbone = XUTBackbone(hidden_dim, xut_heads, mlp, xut_depth,
                                    xut_enc_blocks, xut_dec_blocks,
                                    shared=True)
        self.post_tread = TBackbone(hidden_dim, xut_heads, mlp,
                                    tread_post_depth, shared=True)
        self.out_proj = nn.Linear(hidden_dim, feat_dim)

    def routes(self) -> bool:
        return self.training and self.tread_dropout > 0

    def draw(self, batch: int, length: int, device,
             generator: Optional[torch.Generator] = None) -> dict:
        """The sine source's noise [B, T] and, where the TREAD route is
        on, its uniforms [B, T]."""
        draws = {"noise": torch.randn((batch, length), generator=generator,
                                      device=device)}
        if self.routes():
            draws["route"] = torch.rand((batch, length), generator=generator,
                                        device=device)
        return draws

    def forward(
        self,
        x: torch.Tensor,        # [B, T, feat_dim] noisy mel
        t: torch.Tensor,        # [B] timestep
        asr: torch.Tensor,      # [B, T, asr_dim]
        f0: torch.Tensor,       # [B, T]
        energy: torch.Tensor,   # [B, T]
        spk_emb: torch.Tensor,  # [B, spk_dim]
        *,
        draws: Optional[dict] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        b, length, _ = x.shape
        if draws is None:
            draws = self.draw(b, length, x.device, generator)
        asr_e = self.asr_emb2(mish(self.asr_emb1(asr)))
        spk_e = self.spk_emb2(mish(self.spk_emb1(spk_emb)))
        spk_e = spk_e[:, None].expand(b, length, spk_e.shape[-1])
        source = self.m_source(f0, draws["noise"])
        har = torch.cat([source, energy[..., None],
                         t[:, None, None].expand(b, length, 1)], dim=-1)
        x = x + self.prior_generator(har.transpose(1, 2)).transpose(1, 2)
        x = self.in_proj(torch.cat([x, asr_e, spk_e], dim=-1))

        t_emb = self.time_emb(t)
        shared = (self.shared_attn(t_emb), self.shared_xattn(t_emb),
                  self.shared_ffw(t_emb))
        pos = torch.linspace(-1.0, 1.0, length, device=x.device)
        pos = pos[None, :, None].expand(b, length, 1)
        x = self.prev_tread(x, pos, t_emb, shared_adaln=shared)
        if self.routes():
            keep = length - int(length * self.tread_dropout)
            kept = torch.argsort(draws["route"], dim=1)[:, :keep, None]
            y = self.backbone(
                torch.gather(x, 1, kept.expand(-1, -1, x.shape[-1])),
                torch.gather(pos, 1, kept), t_emb, shared_adaln=shared)
            x = torch.scatter(x, 1, kept.expand(-1, -1, x.shape[-1]), y)
        else:
            x = self.backbone(x, pos, t_emb, shared_adaln=shared)
        x = self.post_tread(x, pos, t_emb, shared_adaln=shared)
        return self.out_proj(x)


class CfmMelDecoderWrapper:
    """Binds a ``CfmMelDecoder`` and one set of its draws into the
    ``CfmSampler`` API: ``compute_pred_target`` in training, the n-step
    Euler ``sample`` in validation."""

    def __init__(self, module: CfmMelDecoder, draws: dict):
        self.module, self.draws = module, draws

    def estimator(self, x, t, **conds):
        return self.module(x, t, draws=self.draws, **conds)

    def sampler(self) -> CfmSampler:
        return CfmSampler(self.estimator, non_drop_conds=["spk_emb"])
