"""The acoustic stage's train step, as plain torch in one precision.

A frozen copy of the program's ``train/stages.py``, cut to the acoustic
stage: its losses, the two GAN views of the MRD, one backward of the
total and one AdamW update per trained module.  Where the program casts a
module's parameters and inputs to bf16 (``run_cast``; the MRD and the SLM
always), this copy applies ``StageContext.cast`` instead: the identity for
the reference, which then computes everything in f32, or a lower precision
for the control.  Random draws come from the step's generator in the
program's order, so the same generator state gives the same noise.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from .. import losses as L
from ..config import Config, ModelConfig
from ..models.norms import set_dropout_generator
from ..ops.mel import MelSpectrogram, calculate_mel, log_norm_energy
from ..ops.multi_spectrogram import MultiSpectrogram
from ..ops.resample import resample
from .loss_log import backwards_loss, weighted_total
from .optim import apply_updates, cosine_logical_lr
from .state import TrainState

STAGE = "acoustic"  # the one stage this copy follows
TRAIN_MODELS = ["speech_predictor", "pitch_energy_predictor",
                "pe_text_encoder", "pe_mel_style_encoder"]
DISCRIMINATORS = ["mrd"]


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def map_floats(tree, fn: Callable[[torch.Tensor], torch.Tensor]):
    """``fn`` on every floating tensor of a nest of tuples, lists, dicts
    and dataclasses; everything else passes through."""
    if torch.is_tensor(tree):
        return fn(tree) if tree.is_floating_point() else tree
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_floats(t, fn) for t in tree)
    if isinstance(tree, dict):
        return {k: map_floats(v, fn) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: map_floats(getattr(tree, f.name), fn)
            for f in dataclasses.fields(tree)})
    return tree


def run_cast(module: nn.Module, cast, *args, detach=False, **kwargs):
    """``module(*args, **kwargs)`` on ``cast`` copies of its parameters and
    floating positional inputs, outputs returned in f32."""
    params = {n: cast(p.detach() if detach else p)
              for n, p in module.named_parameters()}
    out = functional_call(module, params, map_floats(args, cast), kwargs,
                          strict=False)
    return map_floats(out, lambda t: t.float())


@dataclass
class StageContext:
    model_config: ModelConfig
    config: Config
    mel_mean: float
    mel_std: float
    step_limit: int
    slm: nn.Module
    cast: Callable[[torch.Tensor], torch.Tensor] = identity
    weights: Dict[str, float] = field(init=False)

    def __post_init__(self):
        mc = self.model_config
        self.to_mel = MelSpectrogram(
            n_mels=mc.n_mels, n_fft=mc.n_fft, win_length=mc.win_length,
            hop_length=mc.hop_length, sample_rate=mc.sample_rate)
        self.multi_spectrogram = MultiSpectrogram(mc.sample_rate)
        self.weights = dataclasses.asdict(self.config.loss_weight)

    def apply(self, state: TrainState, key: str, *args, **kwargs):
        return run_cast(state.models[key], self.cast, *args, **kwargs)

    def magphase_params(self) -> Dict[str, int]:
        mc = self.model_config
        gc = mc.generator
        if gc.type == "freegan":
            return dict(n_fft=mc.n_fft, hop_length=mc.hop_length // 4,
                        win_length=mc.win_length)
        return dict(n_fft=gc.gen_istft_n_fft,
                    hop_length=gc.gen_istft_hop_size,
                    win_length=gc.gen_istft_n_fft)

    def mel_and_energy(self, audio_gt: torch.Tensor):
        mel, mel_length = calculate_mel(audio_gt, self.to_mel, self.mel_mean,
                                        self.mel_std)
        energy = log_norm_energy(mel, self.mel_mean, self.mel_std).detach()
        return mel, mel_length, energy

    def slm_loss(self, audio_gt: torch.Tensor, audio_pred: torch.Tensor
                 ) -> torch.Tensor:
        from ..models.slm import slm_feature_loss

        sr, slm_sr = self.model_config.sample_rate, self.model_config.slm.sr

        def run(x):
            return run_cast(self.slm, self.cast, x, detach=True)

        with torch.no_grad():
            gt_states = run(resample(audio_gt, sr, slm_sr))
        pred16 = resample(audio_pred, sr, slm_sr)
        pred_states = checkpoint(run, pred16, use_reentrant=False)
        return slm_feature_loss(gt_states, pred_states)


def _acoustic_losses(ctx: StageContext, state: TrainState, batch, **hooks):
    mel, _, energy = ctx.mel_and_energy(batch["audio_gt"])
    pred = ctx.apply(
        state, "speech_predictor", batch["text"], batch["text_length"],
        batch["alignment"], batch["pitch"], energy, batch["audio_gt"],
        **hooks)
    pe_enc, _, _ = ctx.apply(state, "pe_text_encoder", batch["text"],
                             batch["text_length"])
    pe_mel_style = ctx.apply(state, "pe_mel_style_encoder", mel,
                             update_stats=True)
    pred_pitch, pred_energy = ctx.apply(
        state, "pitch_energy_predictor", pe_enc, batch["text_length"],
        batch["alignment"], pe_mel_style)
    t_mag, p_mag, _, _, t_fft, p_fft = ctx.multi_spectrogram(
        target=batch["audio_gt"], pred=pred.audio)
    mag_l, phase_l = L.magphase_loss(pred.magnitude, pred.phase,
                                     batch["audio_gt"],
                                     **ctx.magphase_params())
    metrics = {
        "mel": L.multi_resolution_stft_loss(t_mag, p_mag),
        "slm": ctx.slm_loss(batch["audio_gt"], pred.audio),
        "mag": mag_l,
        "phase": phase_l,
        "pitch": L.smooth_l1_loss(pred_pitch, batch["pitch"]),
        "energy": L.smooth_l1_loss(pred_energy, energy),
    }
    return metrics, (t_fft, p_fft)


def gan_losses(ctx: StageContext, mrd: nn.Module, t_fft, p_fft):
    """The two views of the MRD, each recomputed in the backward (f32
    activations of both views at once would not fit the card beside the
    generator's graph; the recompute is the same ops on the same
    inputs)."""
    targets = [t.detach() for t in t_fft]

    def gen_view(*preds):
        return run_cast(mrd, ctx.cast, targets, list(preds), detach=True)

    def disc_view(*preds):
        return run_cast(mrd, ctx.cast, targets, list(preds))[:2]

    g_rs, g_gs, g_rf, g_gf = checkpoint(gen_view, *p_fft,
                                        use_reentrant=False)
    gen_loss = L.generator_adversarial_loss(g_rs, g_gs, g_rf, g_gf)
    d_rs, d_gs = checkpoint(disc_view, *[p.detach() for p in p_fft],
                            use_reentrant=False)
    d_total, d_plain = L.discriminator_loss(d_rs, d_gs)
    return gen_loss, d_total, d_plain


def make_train_step(ctx: StageContext, base_lr: float):
    """step(state, batch, generator) -> (state, metrics), in place."""
    updated = TRAIN_MODELS + DISCRIMINATORS

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None, **hooks):
        for key, module in state.models.items():
            module.requires_grad_(key in updated)
        for key in TRAIN_MODELS:
            state.models[key].train()
            set_dropout_generator(state.models[key], generator)
        for key in updated:
            state.optimizers[key].zero_grad(set_to_none=True)
        batch_size = batch["text"].shape[0]
        try:
            metrics, (t_fft, p_fft) = _acoustic_losses(
                ctx, state, batch, generator=generator, **hooks)
        finally:
            for key in TRAIN_MODELS:
                state.models[key].eval()
        gen_loss, d_total, d_plain = gan_losses(
            ctx, state.models["mrd"], t_fft, p_fft)
        metrics["generator"] = gen_loss
        total = backwards_loss(metrics, ctx.weights)
        total = total + d_total * math.sqrt(batch_size)
        total.backward()

        lr = cosine_logical_lr(base_lr, state.step, ctx.step_limit)
        for key in TRAIN_MODELS:
            apply_updates(state.optimizers[key], lr)
        ema = state.disc_ema["mrd"]
        multiplier = float(L.disc_lr_multiplier(ema))
        apply_updates(state.optimizers["mrd"], lr * multiplier)
        state.disc_ema["mrd"] = ema * 0.95 + d_plain.detach() * 0.05
        metrics["discriminator"] = d_total
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = weighted_total(metrics, ctx.weights)
        return state, metrics

    return step
