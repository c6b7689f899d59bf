"""The 'ringformer' generator head (``generator: type: ringformer``):
HiFiGAN-style transposed-conv upsampling with snake activations and a
style-conditioned conformer before each scale, a harmonic-plus-noise
(NSF) source injected at every scale, and a small iSTFT head (n_fft 60,
hop 15 at the default config: 4 x 5 x 15 = 300 samples a mel frame).

The source's STFT runs through the Hopper STFT kernel's small-n_fft path
(``ops/stft_kernel.py``) on the card.  Its draws (one uniform phase per
harmonic, two normals per sample and harmonic) come from an explicit
generator, or from ``nsf_draws``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from ..ops.stft import STFTHead
from .conformer import Conformer
from .generator import DecoderPrediction
from .norms import AdaptiveGeneratorBlock, snake


class SourceModuleHnNSF(nn.Module):
    """[B, T] sample-rate F0 -> [B, T, 1] source: the fundamental and 8
    overtones of amplitude 0.1 plus noise of std 0.003 where voiced (F0 >
    10 Hz), noise of std 0.1/3 elsewhere, merged by a tanh linear layer
    (``merge``)."""

    harmonics = 9
    sine_amp = 0.1
    noise_std = 0.003
    voiced_threshold = 10.0

    def __init__(self, sample_rate: int):
        super().__init__()
        self.sample_rate = sample_rate
        self.merge = nn.Linear(self.harmonics, 1)

    def draw(self, b: int, t: int, device,
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        """The source's draws: ``phase`` uniform [B, 1, H], ``noise`` and
        ``noise_uv`` standard normal [B, T, H]."""
        h = self.harmonics
        return {
            "phase": torch.rand((b, 1, h), generator=generator,
                                device=device),
            "noise": torch.randn((b, t, h), generator=generator,
                                 device=device),
            "noise_uv": torch.randn((b, t, h), generator=generator,
                                    device=device),
        }

    def forward(self, f0_up: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.Tensor:
        b, t = f0_up.shape
        if draws is None:
            draws = self.draw(b, t, f0_up.device, generator)
        harmonics = torch.arange(1, self.harmonics + 1, dtype=torch.float32,
                                 device=f0_up.device)
        rad = torch.cumsum(f0_up / self.sample_rate, dim=1)
        rad = rad[:, :, None] * harmonics + draws["phase"]
        sines = self.sine_amp * torch.sin(2.0 * math.pi * rad)
        voiced = (f0_up > self.voiced_threshold)[..., None]
        source = torch.where(voiced, sines, 0.0) + torch.where(
            voiced, self.noise_std * draws["noise"],
            self.sine_amp / 3.0 * draws["noise_uv"])
        return torch.tanh(self.merge(source.to(self.merge.weight.dtype)))


def upsample_linear(x: torch.Tensor, factor: int) -> torch.Tensor:
    """[B, T] -> [B, T*factor] linear interpolation (align_corners=False)."""
    t = x.shape[1]
    pos = (torch.arange(factor * t, dtype=torch.float32, device=x.device)
           + 0.5) / factor - 0.5
    lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, t - 1)
    hi = torch.clamp(lo + 1, 0, t - 1)
    w = torch.clamp(pos - lo, 0.0, 1.0)
    return x[:, lo] * (1.0 - w) + x[:, hi] * w


class ConvTranspose1d(nn.Module):
    """flax ``nn.ConvTranspose(padding="SAME")`` on [B, T, C]: exactly
    ``T * stride`` samples out.  flax does not flip the kernel: it
    correlates the stride-dilated input with the kernel, padded
    (pad_a, pad_b) by lax's SAME rule.  ``weight`` keeps the flax kernel
    [k, in, out] as [out, in, k] (a conv's layout, so the weight maps by
    name); torch's transposed conv takes it flipped along time with in and
    out swapped, at padding k - 1 - pad_a."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        k, s = kernel_size, stride
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
        self.padding = k - 1 - pad_a
        # torch's length is (T-1)s - 2p + k + output_padding; cut to T*s
        self.output_padding = max(0, pad_len - 2 * pad_a)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = x.shape[1]
        w = self.weight.flip(-1).transpose(0, 1)  # [in, out, k]
        y = F.conv_transpose1d(x.transpose(1, 2), w, self.bias,
                               stride=self.stride, padding=self.padding,
                               output_padding=self.output_padding)
        return y[:, :, :t * self.stride].transpose(1, 2)


class UpsampleGenerator(nn.Module):
    """mel latent [B, F, input_dim] + style + frame-rate pitch [B, F] ->
    audio [B, F * prod(rates) * hop]."""

    def __init__(self, mc: ModelConfig):
        super().__init__()
        gc = mc.generator
        self.rates = list(gc.upsample_rates)
        self.n_fft = gc.gen_istft_n_fft
        self.hop = gc.gen_istft_hop_size
        self.stft_head = STFTHead(self.n_fft, self.hop, self.n_fft)
        self.res_count = len(gc.resblock_kernel_sizes)
        s = mc.style_dim
        ch = mc.decoder.hidden_dim
        har_ch = 2 * (self.n_fft // 2 + 1)
        self.m_source = SourceModuleHnNSF(mc.sample_rate)
        for i, (rate, kernel) in enumerate(zip(self.rates,
                                               gc.upsample_kernel_sizes)):
            setattr(self, f"alpha_{i}", nn.Parameter(torch.ones(1, 1, ch)))
            setattr(self, f"conformer_{i}", Conformer(ch, gc.depth, s))
            out_ch = gc.upsample_initial_channel // (2 ** (i + 1))
            setattr(self, f"up_{i}", ConvTranspose1d(ch, out_ch, kernel,
                                                     rate))
            if i + 1 < len(self.rates):
                stride_f0 = math.prod(self.rates[i + 1:])
                noise_conv = nn.Conv1d(har_ch, out_ch, stride_f0 * 2,
                                       stride=stride_f0,
                                       padding=(stride_f0 + 1) // 2)
                res_kernel = 7
            else:
                noise_conv = nn.Conv1d(har_ch, out_ch, 1)
                res_kernel = 11
            setattr(self, f"noise_conv_{i}", noise_conv)
            setattr(self, f"noise_res_{i}", AdaptiveGeneratorBlock(
                out_ch, s, kernel_size=res_kernel))
            for j, (rk, rd) in enumerate(zip(gc.resblock_kernel_sizes,
                                             gc.resblock_dilation_sizes)):
                setattr(self, f"resblock_{i}_{j}", AdaptiveGeneratorBlock(
                    out_ch, s, kernel_size=rk, dilation=rd))
            ch = out_ch
        self.alpha_post = nn.Parameter(torch.ones(1, 1, ch))
        self.conv_post = nn.Conv1d(ch, self.n_fft + 2, 7, padding=3)

    def forward(
        self,
        mel: torch.Tensor,    # [B, F, input_dim]
        style: torch.Tensor,  # [B, S]
        pitch: torch.Tensor,  # [B, F] frame-rate F0
        *,
        generator: Optional[torch.Generator] = None,
        nsf_draws: Optional[Dict[str, torch.Tensor]] = None,
    ) -> DecoderPrediction:
        """``nsf_draws`` hands the source its draws."""
        total_up = math.prod(self.rates) * self.hop
        # the harmonic source: a constant of the graph, in f32
        f0_up = upsample_linear(pitch.detach().float(), total_up)
        source = self.m_source(f0_up, generator, nsf_draws)
        har_mag, har_cos, har_sin = self.stft_head.transform(
            source[..., 0].float().contiguous())
        har = torch.cat([har_mag, torch.atan2(har_sin, har_cos)], -1)
        har = har.to(mel.dtype).transpose(1, 2)  # [B, 2 bins, frames]

        x = mel
        for i in range(len(self.rates)):
            x = snake(x, getattr(self, f"alpha_{i}"))
            x = getattr(self, f"conformer_{i}")(x, style)
            x = getattr(self, f"up_{i}")(x)
            x_source = getattr(self, f"noise_conv_{i}")(har).transpose(1, 2)
            x_source = getattr(self, f"noise_res_{i}")(
                x_source[:, :x.shape[1]], style)
            if x_source.shape[1] < x.shape[1]:
                x_source = F.pad(x_source,
                                 (0, 0, 0, x.shape[1] - x_source.shape[1]))
            x = x + x_source
            xs = 0.0
            for j in range(self.res_count):
                xs = xs + getattr(self, f"resblock_{i}_{j}")(x, style)
            x = xs / self.res_count

        x = snake(x, self.alpha_post)
        x = self.conv_post(x.transpose(1, 2)).transpose(1, 2)
        bins = self.n_fft // 2 + 1
        logamp, phase = x[..., :bins], x[..., bins:]
        # replicate-pad one trailing frame: the F+1-frame iSTFT gives
        # exactly F * hop samples
        logamp = torch.cat([logamp, logamp[:, -1:]], dim=1)
        phase = torch.cat([phase, phase[:, -1:]], dim=1)
        audio = self.stft_head.inverse(torch.exp(logamp), torch.cos(phase),
                                       torch.sin(phase))
        # the iSTFT's trim is a strided view; the STFT kernel, which the
        # loss spectrograms run on it, takes contiguous rows
        return DecoderPrediction(audio=audio.contiguous(), magnitude=logamp,
                                 phase=phase)
