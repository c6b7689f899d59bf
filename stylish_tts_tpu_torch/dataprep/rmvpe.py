"""RMVPE: the deep U-net + BiGRU pitch estimator with 360-bin cents
decoding (the JAX package's ``dataprep/rmvpe.py``).

The reference's E2E0(4, 1, (2, 2)) model, so the published checkpoint
converts directly (``scripts/convert_rmvpe.py``).  Module names follow the
flax tree (``in_bn``, ``enc_i/block_j/conv_k``, ``bn_k``, ``shortcut``,
``dec_i/up``, ``cnn``, ``gru/fwd``, ``gru/bwd``, ``head``), so
``convert.load_flax_params`` fills it from a converted file.  Layout: NCHW
with H = time and W = mels, where the JAX package is NHWC.

The log-mel runs one STFT a file through the STFT kernel
(``ops/stft_kernel.py``, n_fft 1024, hop 160, window 1024 on 16 kHz
audio; the plain ``ops/stft.py:stft`` on the CPU).  The net runs in f32
with TF32 off (``device.resolve_device``), its batch norms on their
running statistics.

Cents decoding: 360 bins at 20-cent resolution; f0 = 10·2^(cents/1200),
cents from a local weighted average around the argmax bin.
"""

from __future__ import annotations

import warnings
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..models.wespeaker import FrozenBatchNorm
from ..ops.stft_kernel import stft_forward

N_CLASS = 360
N_MELS = 128
CENTS_PER_BIN = 20.0
CENTS_OFFSET = 1997.3794084376191  # cents of the first bin above 10 Hz
SAMPLE_RATE = 16000
N_FFT, HOP, WIN = 1024, 160, 1024  # the log-mel's STFT
FRAME_MULTIPLE = 32  # the U-net's five 2x2 pools need T a multiple of 32


class ConvBlockRes(nn.Module):
    """conv-BN-relu x2 with a residual; convs bias-free, a 1x1 shortcut
    (with bias) where the channels change."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv_0 = nn.Conv2d(in_channels, out_channels, 3, padding=1,
                                bias=False)
        self.bn_0 = FrozenBatchNorm(out_channels)
        self.conv_1 = nn.Conv2d(out_channels, out_channels, 3, padding=1,
                                bias=False)
        self.bn_1 = FrozenBatchNorm(out_channels)
        self.shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                         if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn_0(self.conv_0(x)))
        h = F.relu(self.bn_1(self.conv_1(h)))
        return h + (x if self.shortcut is None else self.shortcut(x))


class ResEncoderBlock(nn.Module):
    """``n_blocks`` ConvBlockRes, then (with ``pool``) a 2x2 average pool;
    returns (features, pooled) or the features."""

    def __init__(self, in_channels: int, out_channels: int, n_blocks: int,
                 pool: bool):
        super().__init__()
        self.n_blocks, self.pool = n_blocks, pool
        for j in range(n_blocks):
            setattr(self, f"block_{j}", ConvBlockRes(
                in_channels if j == 0 else out_channels, out_channels))

    def forward(self, x: torch.Tensor):
        for j in range(self.n_blocks):
            x = getattr(self, f"block_{j}")(x)
        return (x, F.avg_pool2d(x, 2)) if self.pool else x


class FlaxConvTranspose2d(nn.Module):
    """flax ``ConvTranspose(3x3, stride 2, padding (1, 2))`` without bias:
    torch's ``ConvTranspose2d(3, stride 2, padding 1, output_padding 1)``
    with the kernel flipped in space.  ``weight`` [out, in, 3, 3] holds
    the flax kernel [3, 3, in, out] as ``convert.py`` lays every 2-D conv
    kernel, so the flip and the in/out swap happen at the call."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               3, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.transpose(0, 1).flip(2, 3)
        return F.conv_transpose2d(x, w, stride=2, padding=1,
                                  output_padding=1)


class ResDecoderBlock(nn.Module):
    """Transposed conv (bias-free, stride 2) + BN + relu, the skip
    concatenated, ``n_blocks`` ConvBlockRes."""

    def __init__(self, in_channels: int, out_channels: int, n_blocks: int):
        super().__init__()
        self.n_blocks = n_blocks
        self.up = FlaxConvTranspose2d(in_channels, out_channels)
        self.bn = FrozenBatchNorm(out_channels)
        for j in range(n_blocks):
            setattr(self, f"block_{j}", ConvBlockRes(
                2 * out_channels if j == 0 else out_channels, out_channels))

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = torch.cat([F.relu(self.bn(self.up(x))), skip], dim=1)
        for j in range(self.n_blocks):
            x = getattr(self, f"block_{j}")(x)
        return x


class GRUCell(nn.Module):
    """flax ``GRUCell``'s parameters: input projections ``ir``, ``iz``,
    ``in`` with bias, hidden projections ``hr``, ``hz`` without and ``hn``
    with.  That is torch's GRU with the r and z gates' hidden bias 0."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        for gate in ("r", "z", "n"):
            self.add_module(f"i{gate}", nn.Linear(in_features, hidden))
            self.add_module(f"h{gate}", nn.Linear(hidden, hidden,
                                                  bias=gate == "n"))

    def gru_weights(self):
        """[w_ih, w_hh, b_ih, b_hh] in torch's gate order (r, z, n)."""
        gates = [getattr(self, f"h{g}") for g in "rzn"]
        inputs = [getattr(self, f"i{g}") for g in "rzn"]
        hn_bias = gates[2].bias
        return [torch.cat([m.weight for m in inputs]),
                torch.cat([m.weight for m in gates]),
                torch.cat([m.bias for m in inputs]),
                torch.cat([torch.zeros_like(hn_bias),
                           torch.zeros_like(hn_bias), hn_bias])]


class BiGRU(nn.Module):
    """One bidirectional GRU layer over [B, T, C] -> [B, T, 2 * hidden]:
    the forward cell's outputs, then the backward cell's in time order."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.fwd = GRUCell(in_features, hidden)
        self.bwd = GRUCell(in_features, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h0 = x.new_zeros(2, x.shape[0], self.hidden)
        weights = self.fwd.gru_weights() + self.bwd.gru_weights()
        with warnings.catch_warnings():
            # cuDNN packs the 1 M weights into its own layout each call
            warnings.filterwarnings("ignore", message="RNN module weights")
            out, _ = torch.gru(x, h0, weights, True, 1, 0.0, False, True,
                               True)
        return out


class RMVPE(nn.Module):
    """log mel [B, T, 128] (T a multiple of 32) -> salience [B, T, 360] in
    (0, 1).

    E2E0(n_blocks=4, n_gru=1, kernel=(2, 2)): 5 encoder levels 16..256,
    4 intermediate blocks at 512, 5 decoder levels, a 3-channel conv,
    BiGRU(384, 256), Linear(512, 360), sigmoid."""

    def __init__(self, en_out_channels: int = 16, en_de_layers: int = 5,
                 inter_layers: int = 4, n_blocks: int = 4,
                 gru_hidden: int = 256):
        super().__init__()
        self.en_de_layers, self.inter_layers = en_de_layers, inter_layers
        self.in_bn = FrozenBatchNorm(1)
        c_in, c = 1, en_out_channels
        for i in range(en_de_layers):
            setattr(self, f"enc_{i}", ResEncoderBlock(c_in, c, n_blocks,
                                                      pool=True))
            c_in, c = c, 2 * c
        for i in range(inter_layers):
            setattr(self, f"inter_{i}", ResEncoderBlock(c_in, c, n_blocks,
                                                        pool=False))
            c_in = c
        for i in range(en_de_layers):
            c //= 2
            setattr(self, f"dec_{i}", ResDecoderBlock(c_in, c, n_blocks))
            c_in = c
        self.cnn = nn.Conv2d(c, 3, 3, padding=1)
        self.gru = BiGRU(3 * N_MELS, gru_hidden)
        self.head = nn.Linear(2 * gru_hidden, N_CLASS)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.in_bn(mel[:, None])  # [B, 1, T, M]
        skips = []
        for i in range(self.en_de_layers):
            skip, x = getattr(self, f"enc_{i}")(x)
            skips.append(skip)
        for i in range(self.inter_layers):
            x = getattr(self, f"inter_{i}")(x)
        for i in range(self.en_de_layers):
            x = getattr(self, f"dec_{i}")(x, skips[-(i + 1)])
        x = self.cnn(x)  # [B, 3, T, M]
        b, ch, t, m = x.shape
        x = x.permute(0, 2, 1, 3).reshape(b, t, ch * m)  # channel-major
        return torch.sigmoid(self.head(self.gru(x)))


def rmvpe_mel_basis() -> np.ndarray:
    """librosa.filters.mel(sr=16000, n_fft=1024, n_mels=128, fmin=30,
    fmax=8000, htk=True) with slaney area normalisation."""
    sr, n_fft, n_mels, fmin, fmax = SAMPLE_RATE, N_FFT, N_MELS, 30.0, 8000.0

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)

    fft_freqs = np.linspace(0, sr / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    weights = np.zeros((n_mels, n_fft // 2 + 1), np.float32)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    # slaney normalisation: divide by band width
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights


def decode_cents(salience: np.ndarray, threshold: float = 0.03
                 ) -> np.ndarray:
    """Local weighted-average cents decoding: salience [T, 360] -> f0 [T]
    (0 where the peak is below ``threshold``)."""
    center = salience.argmax(axis=1)
    t = salience.shape[0]
    cents = np.zeros(t)
    for i in range(t):
        lo = max(0, center[i] - 4)
        hi = min(N_CLASS, center[i] + 5)
        window = salience[i, lo:hi]
        bins = np.arange(lo, hi)
        denom = window.sum()
        if denom > 0:
            cents[i] = (window * bins).sum() / denom * CENTS_PER_BIN \
                + CENTS_OFFSET
    f0 = 10.0 * 2.0 ** (cents / 1200.0)
    voiced = salience.max(axis=1) > threshold
    return np.where(voiced & (cents > 0), f0, 0.0).astype(np.float32)


def reflect_frames(n: int, total: int) -> torch.Tensor:
    """Indices of ``total`` frames that extend ``n`` frames by reflection
    (numpy's ``pad(mode="reflect")``, also past one period)."""
    i = torch.arange(total)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    j = i % period
    return torch.where(j < n, j, period - j)


class RMVPEInference:
    """16 kHz audio -> f0 on ``device`` (the card unless named), the net's
    weights from a converted safetensors file (``scripts/convert_rmvpe.py``)
    or, without one, drawn from a seed (the JAX package falls back to its
    random initialisation too)."""

    def __init__(self, weights_path: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        model = RMVPE()
        if weights_path:
            from ..export.import_torch import load_converted_module

            load_converted_module(weights_path, "rmvpe", model)
        else:
            from ..train.init import init_params

            init_params(model, torch.Generator().manual_seed(0))
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.mel_basis = torch.from_numpy(rmvpe_mel_basis()).to(self.device)

    def mel(self, audio: torch.Tensor) -> torch.Tensor:
        """[B, samples] f32 on the device -> log-mel [B, T, 128]."""
        real, imag = stft_forward(audio, n_fft=N_FFT, hop_length=HOP,
                                  win_length=WIN)
        mag = torch.sqrt(real * real + imag * imag)
        mel = torch.einsum("btf,mf->btm", mag, self.mel_basis)
        return torch.log(torch.clamp(mel, min=1e-5))

    @torch.no_grad()
    def salience(self, audio16k) -> torch.Tensor:
        """[samples] audio (numpy or a tensor) -> salience [T, 360] on the
        device, T = samples // 160 + 1; the mel is reflect-padded to a
        multiple of 32 frames for the net and cut back after it."""
        x = torch.as_tensor(audio16k, dtype=torch.float32,
                            device=self.device).reshape(1, -1).contiguous()
        mel = self.mel(x)
        n = mel.shape[1]
        total = FRAME_MULTIPLE * ((n - 1) // FRAME_MULTIPLE + 1)
        if total != n:
            mel = mel[:, reflect_frames(n, total).to(self.device)]
        return self.model(mel)[0, :n]

    def __call__(self, audio16k) -> np.ndarray:
        """[samples] 16 kHz audio -> f0 [samples // 160 + 1] (0 unvoiced)."""
        return decode_cents(self.salience(audio16k).cpu().numpy())
