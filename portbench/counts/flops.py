"""Model FLOP of one train step or one synthesis batch, by the type they
run in, counted on the meta device over the frozen reference.

``torch.utils.flop_counter``'s formulas count every matrix product,
convolution and attention by its shapes.  The reference runs each model
through ``StageContext.cast``, where the program casts to bf16, so a count
with that cast set to bf16 sees the program's types: those FLOP are held
at the bf16 peak, the rest (losses, mel filterbank, synthesis) at f32's.
The STFT and the inverse STFT are counted by the FFT formula
(``counts/stft.py``), forward and, where the input takes a gradient,
backward, whatever the reference computes them with (a DFT by matrix
product).  Recomputation is not counted: the SLM's checkpoint runs once.
The optimizer's update is not model FLOP.
"""

from __future__ import annotations

from collections import defaultdict
from contextlib import ExitStack
from typing import Dict, List
from unittest import mock

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from . import stft as stft_counts


class DtypeFlops(TorchDispatchMode):
    """FLOP of the ops dispatched under it, by "bf16" or "f32" (the type of
    the op's first floating input)."""

    def __init__(self):
        super().__init__()
        self.flops: Dict[str, float] = defaultdict(float)

    def add(self, dtype: str, flops: float) -> None:
        self.flops[dtype] += flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            first = next((a for a in args if torch.is_tensor(a)
                          and a.is_floating_point()), None)
            kind = ("bf16" if first is not None and first.dtype in (
                torch.bfloat16, torch.float16) else "f32")
            self.add(kind, float(flop_registry[packet](*args, **kwargs,
                                                       out_val=out)))
        return out


class _Shaped(torch.autograd.Function):
    """Outputs of the given shapes, uncomputed, whose backward hands the
    input an uncomputed gradient: the graph stays connected and no op is
    counted."""

    @staticmethod
    def forward(ctx, x, shapes):
        ctx.shape = x.shape
        return tuple(x.new_empty(s, dtype=torch.float32) for s in shapes)

    @staticmethod
    def backward(ctx, *grads):
        return grads[0].new_empty(ctx.shape), None


def _counted_stft(counter: DtypeFlops):
    def stft_forward(x, *, n_fft: int, hop_length: int, win_length: int):
        batch, samples = x.shape
        flops, _ = stft_counts.work(batch, samples, n_fft, hop_length)
        counter.add("f32", flops * (2 if x.requires_grad else 1))
        n_frames = stft_counts.frames(samples, hop_length)
        shape = (batch, n_frames, n_fft // 2 + 1)
        return _Shaped.apply(x, (shape, shape))
    return stft_forward


def _counted_istft(counter: DtypeFlops):
    def istft(real, imag, *, n_fft: int, hop_length: int, win_length: int,
              length=None, center: bool = True):
        batch, n_frames, _ = real.shape
        flops = stft_counts.istft_flops(batch, n_frames, n_fft)
        grad = real.requires_grad or imag.requires_grad
        counter.add("f32", flops * (2 if grad else 1))
        samples = length if length is not None else (n_frames - 1) * hop_length
        both = torch.stack([real, imag])
        (audio,) = _Shaped.apply(both, ((batch, samples),))
        return audio
    return istft


def _patches(counter: DtypeFlops) -> List:
    from ..reference import losses
    from ..reference.models import flow
    from ..reference.ops import mel, multi_spectrogram, stft, stft_kernel
    from ..reference.train import stages

    fwd, inv = _counted_stft(counter), _counted_istft(counter)
    return ([mock.patch.object(m, "stft_forward", fwd) for m in
             (losses, flow, mel, multi_spectrogram, stft_kernel)]
            + [mock.patch.object(stft, "istft", inv),
               mock.patch.object(stages, "checkpoint",
                                 lambda fn, *a, **k: fn(*a))])


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16)


def train_step_flops(mc, config, batch: Dict[str, tuple]) -> Dict[str, float]:
    """FLOP by type of the acoustic step's forward and backward at the
    batch's shapes (``batch`` maps each input to its shape and type)."""
    from ..reference import build
    from ..reference.train import stages

    with torch.device("meta"):
        models = build.training_models(mc)
        slm = build.slm(mc)
        inputs = {k: torch.zeros(shape, dtype=dtype)
                  for k, (shape, dtype) in batch.items()}
    ctx = stages.StageContext(model_config=mc, config=config, mel_mean=-4.0,
                              mel_std=4.0, step_limit=10_000, slm=slm,
                              cast=bf16)
    state = build.TrainState(models=models, optimizers={}, disc_ema={})
    counter = DtypeFlops()
    with ExitStack() as stack:
        for patch in _patches(counter):
            stack.enter_context(patch)
        with counter:
            for key in stages.TRAIN_MODELS:
                models[key].train()
            metrics, (t_fft, p_fft) = stages._acoustic_losses(
                ctx, state, inputs)
            gen, d_total, _ = stages.gan_losses(ctx, models["mrd"], t_fft,
                                                p_fft)
            total = gen + d_total + sum(metrics.values())
            total.backward()
    return dict(counter.flops)


def synth_batch_flops(mc, tokens: int, frames: int, batch: int
                      ) -> Dict[str, float]:
    """FLOP by type of one synthesis batch of ``batch`` utterances padded
    to ``tokens`` tokens and ``frames`` frames, in f32 (the program's
    synthesis type)."""
    from ..reference import build

    with torch.device("meta"):
        models = build.inference_models(mc)
        ids = torch.zeros((batch, tokens), dtype=torch.int64)
        lengths = torch.full((batch,), tokens, dtype=torch.int64)
        alignment = torch.zeros((batch, tokens, frames))
    counter = DtypeFlops()
    with ExitStack() as stack:
        for patch in _patches(counter):
            stack.enter_context(patch)
        with counter, torch.no_grad():
            pe_enc, _, _ = models["pe_text_encoder"](ids, lengths)
            style = models["pe_text_style_encoder"](pe_enc, lengths)
            pitch, energy = models["pitch_energy_predictor"](
                pe_enc, lengths, alignment, style)
            models["speech_predictor"](ids, lengths, alignment, pitch,
                                       energy)
    return dict(counter.flops)
