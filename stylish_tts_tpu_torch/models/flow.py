"""VITS-style normalizing flow: gated WaveNet couplings over the latent,
transporting (z, mean, logstd) triples in both directions, plus the prior
encoder and the posterior encoder (training only).

``remat=True`` (``ModelConfig.remat_flow``) recomputes each coupling
layer's activations, and the posterior encoder's WaveNet's, in the
backward instead of keeping them: the flow runs at the generator's frame
rate (4x the mel's), so they are among the largest of the acoustic step.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..ops.stft_kernel import stft_forward
from .norms import Conv1d, Conv1x1, Dropout

FlowTriple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def remat_call(module: nn.Module, remat: bool, *args):
    """``module(*args)``; with ``remat`` and autograd recording, its
    activations are recomputed in the backward (non-reentrant
    checkpointing), so synthesis under ``no_grad`` is unchanged.

    The recompute runs after the caller's ``functional_call`` has put the
    f32 masters back (``train/stages.py:run_cast``), so it reinstates the
    tensors the module holds now, bf16 copies included.  Only the global
    RNG streams are restored for it: a region that draws from an explicit
    generator (``norms.Dropout`` at a rate above 0) would draw anew."""
    if not (remat and torch.is_grad_enabled()):
        return module(*args)
    tensors = {**dict(module.named_parameters()),
               **dict(module.named_buffers())}
    return checkpoint(lambda *a: functional_call(module, tensors, a), *args,
                      use_reentrant=False)


class WaveNet(nn.Module):
    """Non-causal WaveNet with gated tanh/sigmoid units and global style
    conditioning.  No caller masks it or dilates it (the JAX package's
    mask is always None and its dilation rate 1)."""

    def __init__(self, hidden_channels: int, kernel_size: int, n_layers: int,
                 cond_channels: int = 0, dropout: float = 0.0):
        super().__init__()
        h = hidden_channels
        self.hidden_channels = h
        self.n_layers = n_layers
        self.dropout = Dropout(dropout)
        self.cond_layer = (nn.Linear(cond_channels, 2 * h * n_layers)
                           if cond_channels else None)
        for i in range(n_layers):
            setattr(self, f"in_{i}", Conv1d(h, 2 * h, kernel_size))
            out = 2 * h if i < n_layers - 1 else h
            setattr(self, f"res_skip_{i}", nn.Linear(h, out))

    def forward(self, x: torch.Tensor,
                cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.hidden_channels
        output = torch.zeros_like(x)
        if cond is not None:
            g_all = self.cond_layer(cond)
        for i in range(self.n_layers):
            x_in = getattr(self, f"in_{i}")(x)
            if cond is not None:
                x_in = x_in + g_all[:, None, 2 * h * i : 2 * h * (i + 1)]
            acts = torch.tanh(x_in[..., :h]) * torch.sigmoid(x_in[..., h:])
            acts = self.dropout(acts)
            res_skip = getattr(self, f"res_skip_{i}")(acts)
            if i < self.n_layers - 1:
                x = x + res_skip[..., :h]
                output = output + res_skip[..., h:]
            else:
                output = output + res_skip
        return output


class ResidualCouplingLayer(nn.Module):
    """One affine coupling transporting (z, mean, logstd) halves; the
    inverse direction (``reverse=True``) maps the prior to the mel latent,
    the forward direction the posterior to the text latent."""

    def __init__(self, half_channels: int, hidden_channels: int,
                 kernel_size: int, n_layers: int, cond_channels: int = 0):
        super().__init__()
        self.pre = nn.Linear(half_channels, hidden_channels)
        self.enc = WaveNet(hidden_channels, kernel_size, n_layers,
                           cond_channels=cond_channels)
        self.proj_mean = nn.Linear(hidden_channels, half_channels)
        self.proj_logstd = nn.Linear(hidden_channels, half_channels)

    def forward(self, zs, means, logstds, cond=None, reverse: bool = False):
        z0, z1 = zs
        mean0, mean1 = means
        logstd0, logstd1 = logstds
        h = self.enc(self.pre(z0), cond=cond)
        mean_flow = self.proj_mean(h)
        logstd_flow = self.proj_logstd(h)
        if reverse:
            scale = torch.exp(-logstd_flow)
            z1 = (z1 - mean_flow) * scale
            mean1 = (mean1 - mean_flow) * scale
            logstd1 = logstd1 - logstd_flow
        else:
            scale = torch.exp(logstd_flow)
            z1 = mean_flow + z1 * scale
            mean1 = mean_flow + mean1 * scale
            logstd1 = logstd1 + logstd_flow
        return (z0, z1), (mean0, mean1), (logstd0, logstd1)


def _flip(pair):
    a, b = pair
    return (b, a)


class ResidualCouplingBlock(nn.Module):
    """n_flows × (coupling + flip).  The inverse direction
    (``reverse=True``, synthesis) runs the flows in reverse order, each
    preceded by its flip; the forward direction serves training.
    ``remat`` checkpoints each coupling layer, in both directions."""

    def __init__(self, channels: int, hidden_channels: int,
                 kernel_size: int = 5, n_layers: int = 4, n_flows: int = 8,
                 cond_channels: int = 0, remat: bool = False):
        super().__init__()
        self.half = channels // 2
        self.n_flows = n_flows
        self.remat = remat
        for i in range(n_flows):
            setattr(self, f"flow_{i}", ResidualCouplingLayer(
                self.half, hidden_channels, kernel_size, n_layers,
                cond_channels=cond_channels))

    def forward(self, z, mean, logstd, cond=None,
                reverse: bool = False) -> FlowTriple:
        half = self.half
        zs = (z[..., :half], z[..., half:])
        means = (mean[..., :half], mean[..., half:])
        logstds = (logstd[..., :half], logstd[..., half:])
        if reverse:
            for i in reversed(range(self.n_flows)):
                zs, means, logstds = _flip(zs), _flip(means), _flip(logstds)
                zs, means, logstds = remat_call(
                    getattr(self, f"flow_{i}"), self.remat, zs, means,
                    logstds, cond, True)
        else:
            for i in range(self.n_flows):
                zs, means, logstds = remat_call(
                    getattr(self, f"flow_{i}"), self.remat, zs, means,
                    logstds, cond, False)
                zs, means, logstds = _flip(zs), _flip(means), _flip(logstds)
        return (torch.cat(zs, -1), torch.cat(means, -1),
                torch.cat(logstds, -1))


class PriorEncoder(nn.Module):
    """Linear heads producing (z, mean, logstd) from decoder features."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.proj_mean = nn.Linear(in_channels, out_channels)
        self.proj_logstd = nn.Linear(in_channels, out_channels)

    def forward(self, x: torch.Tensor, *, sample: bool = True,
                generator: Optional[torch.Generator] = None) -> FlowTriple:
        mean = self.proj_mean(x)
        logstd = self.proj_logstd(x)
        if not sample:
            return mean, mean, logstd
        noise = torch.randn(mean.shape, generator=generator,
                            dtype=mean.dtype, device=mean.device)
        return mean + noise * torch.exp(logstd), mean, logstd


class PosteriorEncoder(nn.Module):
    """Waveform -> STFT magnitude and phase -> 1x1 convs -> WaveNet ->
    (z, mean, logstd).  The STFT runs at the generator's frame rate, in
    f32; its outputs return to the activation type.  ``remat``
    checkpoints the WaveNet alone: the STFT kernel is not launched again
    in the backward."""

    def __init__(self, out_channels: int, hidden_channels: int, n_fft: int,
                 win_length: int, hop_length: int, kernel_size: int = 3,
                 n_layers: int = 12, cond_channels: int = 0,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.n_fft, self.win_length, self.hop_length = \
            n_fft, win_length, hop_length
        freq_bins = n_fft // 2 + 1
        h = hidden_channels
        self.pre_spec = Conv1x1(freq_bins, h // 2)
        self.pre_phase = Conv1x1(freq_bins, h // 2)
        self.enc = WaveNet(h, kernel_size, n_layers,
                           cond_channels=cond_channels)
        self.proj_mean = nn.Linear(h, out_channels)
        self.proj_logstd = nn.Linear(h, out_channels)

    def forward(self, audio: torch.Tensor,
                cond: Optional[torch.Tensor] = None, *, sample: bool = True,
                generator: Optional[torch.Generator] = None) -> FlowTriple:
        real, imag = stft_forward(
            audio.float().contiguous(), n_fft=self.n_fft,
            hop_length=self.hop_length, win_length=self.win_length)
        act = cond.dtype if cond is not None else audio.dtype
        mag = (torch.hypot(real, imag) + 1e-9)[:, :-1].to(act)
        phase = torch.atan2(imag, real)[:, :-1].to(act)  # drop the last frame
        x = torch.cat([self.pre_spec(mag), self.pre_phase(phase)], dim=-1)
        x = remat_call(self.enc, self.remat, x, cond)
        mean = self.proj_mean(x)
        logstd = self.proj_logstd(x)
        if not sample:
            return mean, mean, logstd
        noise = torch.randn(mean.shape, generator=generator,
                            dtype=mean.dtype, device=mean.device)
        return mean + noise * torch.exp(logstd), mean, logstd
