"""'freegan' vocoder head: pseudo-constant-power harmonic (PCPH) prior +
style-conditioned ConvNeXt stack -> log-magnitude & phase -> iSTFT.

The prior's phase integral is a frame-level f32 cumsum plus a within-frame
ramp, exact because F0 is constant within a frame; the harmonic count is
the fixed 16-harmonic cap with a Nyquist mask.  Its STFT runs through the
Hopper kernel (``ops/stft_kernel.py``) on the card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from ..config import ModelConfig
from ..ops.stft import STFTHead
from .convnext import StyleConvNeXtBlock
from .norms import AdaptiveLayerNorm, Conv1d, Conv1x1

MAX_HARMONICS = 16


@dataclass
class DecoderPrediction:
    audio: torch.Tensor      # [B, T_samples]
    magnitude: torch.Tensor  # [B, frames+1, n_fft//2+1] log-amplitude
    phase: torch.Tensor      # [B, frames+1, n_fft//2+1]
    # (z, mean, logstd) of the flow, attached on the training path
    text_stats: Optional[Tuple[torch.Tensor, ...]] = None
    text2mel_stats: Optional[Tuple[torch.Tensor, ...]] = None
    mel_stats: Optional[Tuple[torch.Tensor, ...]] = None
    mel2text_stats: Optional[Tuple[torch.Tensor, ...]] = None


def generate_pcph(
    f0: torch.Tensor,      # [B, F] frame-rate F0 in Hz
    voiced: torch.Tensor,  # [B, F] 1.0 where voiced
    *,
    hop_length: int,
    sample_rate: int,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    phase_offset: Optional[torch.Tensor] = None,
    noise_amplitude: float = 0.01,
    random_init_phase: bool = True,
    power_factor: float = 0.1,
) -> torch.Tensor:
    """Pseudo-constant-power harmonic waveform [B, F * hop_length], in f32.

    ``noise`` (standard normal, [B, F*hop]) and ``phase_offset`` (uniform
    in [0, 1), shape [1, 1]) are drawn from ``generator`` unless given."""
    f0 = f0.float()
    voiced = voiced.float()
    b, frames = f0.shape
    n_samples = frames * hop_length
    device = f0.device
    if noise is None:
        noise = torch.randn((b, n_samples), generator=generator, device=device)
    noise = noise_amplitude * noise

    vuv = torch.round(voiced) > 0.5
    n_harm = torch.where(
        vuv, sample_rate / 2.0 / torch.clamp(f0, min=1e-5), 1.0)
    amplitude = vuv * power_factor * torch.sqrt(2.0 / n_harm)  # [B, F]

    indices = torch.arange(1, MAX_HARMONICS + 1, dtype=torch.float32,
                           device=device)
    harmonic_mask = (
        f0[:, None, :] * indices[None, :, None] <= sample_rate / 2.0
    )  # [B, H, F]

    radians_per_sample = f0 / sample_rate  # [B, F]
    frame_base = torch.cumsum(radians_per_sample * hop_length, dim=1)
    frame_base = torch.cat(
        [torch.zeros((b, 1), device=device), frame_base[:, :-1]], dim=1
    )  # exclusive cumsum
    ramp = torch.arange(1, hop_length + 1, dtype=torch.float32, device=device)
    cum = (
        frame_base[:, :, None]
        + ramp[None, None, :] * radians_per_sample[:, :, None]
    ).reshape(b, n_samples)
    if random_init_phase:
        if phase_offset is None:
            phase_offset = torch.rand((1, 1), generator=generator,
                                      device=device)
        cum = cum + phase_offset

    phases = 2.0 * math.pi * cum[:, None, :] * indices[None, :, None]
    harmonics = torch.sin(phases)  # [B, H, n_samples]
    mask_samples = torch.repeat_interleave(
        harmonic_mask.to(torch.float32), hop_length, dim=2)
    amp_samples = torch.repeat_interleave(amplitude, hop_length, dim=1)
    wave = amp_samples * torch.sum(harmonics * mask_samples, dim=1)
    return wave + noise


class Generator(nn.Module):
    """mel latent [B, F, input_dim] + style + frame-rate pitch -> audio."""

    def __init__(self, mc: ModelConfig):
        super().__init__()
        gc = mc.generator
        if gc.type != "freegan":
            raise ValueError(f"Generator is the freegan head, not {gc.type!r}")
        self.sample_rate = mc.sample_rate
        self.hop = mc.hop_length // 4
        self.stft_head = STFTHead(mc.n_fft, self.hop, mc.win_length)
        freq_bins = mc.n_fft // 2 + 1
        h, s = gc.hidden_dim, mc.style_dim
        self.amp_prior_conv = Conv1d(freq_bins, h // 2, 7)
        self.phase_prior_conv = Conv1d(freq_bins, h // 2, 7)
        self.projector = Conv1x1(mc.decoder.hidden_dim + h, h)
        for i, k in enumerate((31, 15, 7, 3)):
            setattr(self, f"convnext_{i}", StyleConvNeXtBlock(
                h, gc.conv_intermediate_dim, s, kernel=k))
        self.amp_final_norm = AdaptiveLayerNorm(h, s)
        self.amp_output_conv = Conv1d(
            h + h // 2, freq_bins, gc.io_conv_kernel_size)
        self.phase_final_norm = AdaptiveLayerNorm(h, s)
        self.phase_output_conv = Conv1d(
            h + h // 2, freq_bins, gc.io_conv_kernel_size)

    def forward(
        self,
        mel: torch.Tensor,    # [B, F, input_dim]
        style: torch.Tensor,  # [B, S]
        pitch: torch.Tensor,  # [B, F] frame-rate F0 (hop/4 rate)
        *,
        generator: Optional[torch.Generator] = None,
        pcph_noise: Optional[torch.Tensor] = None,
        pcph_phase: Optional[torch.Tensor] = None,
    ) -> DecoderPrediction:
        # harmonic prior: a constant of the graph (no gradient)
        pitch = pitch.detach()
        prior = generate_pcph(
            pitch, (pitch > 10.0).to(torch.float32),
            hop_length=self.hop, sample_rate=self.sample_rate,
            generator=generator, noise=pcph_noise, phase_offset=pcph_phase,
        )
        har_mag, har_cos, har_sin = self.stft_head.transform(
            prior.contiguous())
        har_phase = torch.atan2(har_sin, har_cos)
        har_mag = har_mag[:, :-1].to(mel.dtype)
        har_phase = har_phase[:, :-1].to(mel.dtype)

        logamp_prior = self.amp_prior_conv(har_mag)
        phase_prior = self.phase_prior_conv(har_phase)
        x = self.projector(torch.cat([mel, logamp_prior, phase_prior], -1))
        for i in range(4):
            x = getattr(self, f"convnext_{i}")(x, style)

        logamp = self.amp_output_conv(
            torch.cat([self.amp_final_norm(x, style), logamp_prior], -1))
        phase = self.phase_output_conv(
            torch.cat([self.phase_final_norm(x, style), phase_prior], -1))

        # replicate-pad one trailing frame
        logamp = torch.cat([logamp, logamp[:, -1:]], dim=1)
        phase = torch.cat([phase, phase[:, -1:]], dim=1)

        spec = torch.exp(logamp)
        audio = self.stft_head.inverse(spec, torch.cos(phase),
                                       torch.sin(phase))
        return DecoderPrediction(audio=torch.tanh(audio), magnitude=logamp,
                                 phase=phase)
