"""SpeechPredictor: text encoder, style encoder, decoder, flow prior and
the generator head (freegan, or the ringformer of ``models/ringformer.py``).

Synthesis runs the flow in reverse from the prior.  Training
(``posterior=True`` and ``audio_gt`` given) also encodes the ground truth
with the posterior encoder, runs the flow forward on it, feeds the
posterior latent to the generator and attaches the four flow-stat triples.

The alignment arrives at mel frame rate (hop 300).  For the freegan head
it is repeated ×4 to the generator rate (hop 75), pitch and energy are
linearly upsampled ×4 and the posterior encoder reads the audio at hop 75;
the ringformer head upsamples by itself, so everything stays at the mel
rate and the posterior encoder reads hop 300.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..config import ModelConfig
from .decoder import Decoder
from .duration_predictor import text_encoder_for
from .flow import PosteriorEncoder, PriorEncoder, ResidualCouplingBlock
from .generator import DecoderPrediction, Generator
from .ringformer import UpsampleGenerator
from .style_encoders import TextStyleEncoder


def upsample_x4_linear(x: torch.Tensor) -> torch.Tensor:
    """[B, F] -> [B, 4F] linear interpolation matching
    torch.nn.Upsample(scale_factor=4, mode='linear', align_corners=False)."""
    f = x.shape[1]
    pos = (torch.arange(4 * f, dtype=torch.float32, device=x.device) + 0.5) \
        / 4.0 - 0.5
    lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, f - 1)
    hi = torch.clamp(lo + 1, 0, f - 1)
    w = torch.clamp(pos - lo, 0.0, 1.0).to(x.dtype)
    return x[:, lo] * (1.0 - w) + x[:, hi] * w


def generator_head(mc: ModelConfig) -> nn.Module:
    """The configured generator head: freegan or ringformer."""
    if mc.generator.type == "freegan":
        return Generator(mc)
    if mc.generator.type == "ringformer":
        return UpsampleGenerator(mc)
    raise ValueError(f"unknown generator {mc.generator.type!r}")


def head_draws(freegan: bool, pcph_noise, pcph_phase, nsf_draws) -> dict:
    """The given draws of the head: the harmonic prior's for freegan, the
    NSF source's for the ringformer."""
    if freegan:
        return dict(pcph_noise=pcph_noise, pcph_phase=pcph_phase)
    return dict(nsf_draws=nsf_draws)


class SpeechPredictor(nn.Module):
    def __init__(self, mc: ModelConfig, posterior: bool = False):
        super().__init__()
        self.x4 = mc.generator.type == "freegan"
        self.text_encoder = text_encoder_for(mc, mc.inter_dim)
        self.style_encoder = TextStyleEncoder(
            mc.inter_dim, mc.style_dim, mc.style_encoder.layers)
        hidden = mc.decoder.hidden_dim
        self.decoder = Decoder(mc.inter_dim, hidden, mc.decoder.residual_dim,
                               mc.style_dim)
        flow_dim = hidden // 4
        self.prior_encoder = PriorEncoder(hidden, flow_dim)
        self.flow = ResidualCouplingBlock(
            flow_dim, flow_dim, kernel_size=5, n_layers=4, n_flows=8,
            cond_channels=mc.style_dim, remat=mc.remat_flow)
        self.posterior_encoder = PosteriorEncoder(
            flow_dim, flow_dim, n_fft=mc.n_fft, win_length=mc.win_length,
            hop_length=mc.hop_length // 4 if self.x4 else mc.hop_length,
            n_layers=12, cond_channels=mc.style_dim,
            remat=mc.remat_flow) if posterior else None
        self.post_flow = nn.Linear(flow_dim, hidden)
        self.generator = generator_head(mc)

    def forward(
        self,
        tokens: torch.Tensor,        # [B, T]
        text_lengths: torch.Tensor,  # [B]
        alignment: torch.Tensor,     # [B, T, F_mel]
        pitch: torch.Tensor,         # [B, F_mel]
        energy: torch.Tensor,        # [B, F_mel]
        audio_gt: Optional[torch.Tensor] = None,  # [B, T_samples], training
        *,
        sample: bool = True,
        generator: Optional[torch.Generator] = None,
        pcph_noise: Optional[torch.Tensor] = None,
        pcph_phase: Optional[torch.Tensor] = None,
        nsf_draws: Optional[Dict[str, torch.Tensor]] = None,
    ) -> DecoderPrediction:
        text_encoding, _, _ = self.text_encoder(tokens, text_lengths)
        style = self.style_encoder(text_encoding, text_lengths)

        if self.x4:
            alignment4 = torch.repeat_interleave(alignment, 4, dim=2)
            pitch4 = upsample_x4_linear(pitch)
            energy4 = upsample_x4_linear(energy)
        else:
            alignment4, pitch4, energy4 = alignment, pitch, energy

        asr = torch.einsum("btc,btf->bfc", text_encoding, alignment4)
        x = self.decoder(asr, pitch4, energy4, style)
        text_stats = self.prior_encoder(x, sample=sample, generator=generator)
        text2mel_stats = self.flow(*text_stats, cond=style, reverse=True)
        if audio_gt is None:
            mel = self.post_flow(text2mel_stats[0])
        else:
            mel_stats = self.posterior_encoder(
                audio_gt, cond=style, sample=sample, generator=generator)
            mel2text_stats = self.flow(*mel_stats, cond=style, reverse=False)
            mel = self.post_flow(mel_stats[0])
        prediction = self.generator(
            mel, style, pitch4, generator=generator,
            **head_draws(self.x4, pcph_noise, pcph_phase, nsf_draws))
        if audio_gt is not None:
            prediction.text_stats = text_stats
            prediction.text2mel_stats = text2mel_stats
            prediction.mel_stats = mel_stats
            prediction.mel2text_stats = mel2text_stats
        return prediction
