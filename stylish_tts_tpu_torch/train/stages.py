"""Stage steps: the acoustic stage's losses and the generic train step of
the stages with the MRD discriminator.

``make_train_step(stage, ctx, base_lr)`` returns
``step(state, batch, generator) -> (state, metrics)``, with the JAX
package's metric names.  One step runs the stage's losses, the two GAN
views of the MRD, one backward of the total, and one AdamW update per
module: the generator modules at the cosine LR, the MRD at that LR times
the gap-aware multiplier of its loss EMA.  The state is updated in place.

Mixed precision follows the JAX package's casts, not ``torch.autocast``:
with ``mixed_precision == "bf16"`` each module runs on bf16 copies of its
f32 master parameters and on bf16 inputs, and its outputs return to f32;
the STFT chains, the losses and the optimizer stay f32; the MRD always
runs in bf16; the frozen SLM runs in bf16.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

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

def cast_floats(tree, dtype: torch.dtype):
    """Cast every floating tensor of a nest of tuples, lists, dicts and
    dataclasses to ``dtype``; everything else passes through."""
    if torch.is_tensor(tree):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(t, dtype) for t in tree)
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: cast_floats(getattr(tree, f.name), dtype)
            for f in dataclasses.fields(tree)})
    return tree


def run_cast(module: nn.Module, dtype: torch.dtype, *args, detach=False,
             **kwargs):
    """``module(*args, **kwargs)`` on ``dtype`` copies of its parameters
    and floating positional inputs, outputs returned in f32.  The casts
    are differentiable, so the f32 masters get f32 gradients;
    ``detach=True`` cuts the parameters out of the graph."""
    params = {n: (p.detach() if detach else p).to(dtype)
              for n, p in module.named_parameters()}
    out = functional_call(module, params, cast_floats(args, dtype), kwargs,
                          strict=False)
    return cast_floats(out, torch.float32)


@dataclass
class StageContext:
    """What a stage step closes over: models' configs, normalisation
    stats, the stage length and the frozen feature nets."""

    model_config: ModelConfig
    config: Config
    mel_mean: float
    mel_std: float
    step_limit: int
    slm: Optional[nn.Module] = None  # frozen, for the 'slm' loss
    weights: Dict[str, float] = field(init=False)

    def __post_init__(self):
        mc = self.model_config
        self.to_mel = MelSpectrogram(
            n_mels=mc.n_mels, n_fft=mc.n_fft, win_length=mc.win_length,
            hop_length=mc.hop_length, sample_rate=mc.sample_rate)
        self.multi_spectrogram = MultiSpectrogram(mc.sample_rate)
        self.weights = dataclasses.asdict(self.config.loss_weight)
        self.compute_dtype = (
            torch.bfloat16 if self.config.training.mixed_precision == "bf16"
            else torch.float32)
        if self.slm is not None:
            self.slm = self.slm.to(torch.bfloat16)

    def apply(self, state: TrainState, key: str, *args, **kwargs):
        """Run model ``key`` in the compute type of the config."""
        module = state.models[key]
        if self.compute_dtype == torch.bfloat16:
            return run_cast(module, torch.bfloat16, *args, **kwargs)
        return module(*args, **kwargs)

    def magphase_params(self) -> Dict[str, int]:
        """STFT of the freegan head's native resolution: n_fft at hop/4."""
        mc = self.model_config
        return dict(n_fft=mc.n_fft, hop_length=mc.hop_length // 4,
                    win_length=mc.win_length)

    def mel_and_energy(self, audio_gt: torch.Tensor):
        mel, mel_length = calculate_mel(audio_gt, self.to_mel, self.mel_mean,
                                        self.mel_std)
        energy = log_norm_energy(mel, self.mel_mean, self.mel_std).detach()
        return mel, mel_length, energy

    def slm_loss(self, audio_gt: torch.Tensor, audio_pred: torch.Tensor
                 ) -> torch.Tensor:
        """L1 between the frozen SLM's hidden states of the ground truth
        and the prediction at 16 kHz, in bf16; the prediction's forward is
        recomputed in the backward (its 12 layers' activations would
        dominate the loss path's memory)."""
        from ..models.slm import slm_feature_loss

        sr, slm_sr = self.model_config.sample_rate, self.model_config.slm.sr
        with torch.no_grad():
            gt_states = self.slm(
                resample(audio_gt, sr, slm_sr).to(torch.bfloat16))
        pred16 = resample(audio_pred, sr, slm_sr).to(torch.bfloat16)
        pred_states = checkpoint(self.slm, pred16, use_reentrant=False)
        return slm_feature_loss(gt_states, pred_states)


@dataclass
class StageType:
    compute_losses: Callable
    train_models: List[str]
    discriminators: List[str]


STAGES: Dict[str, StageType] = {}


def _acoustic_losses(ctx: StageContext, state: TrainState, batch, *,
                     sample: bool = True,
                     generator: Optional[torch.Generator] = None,
                     pcph_noise: Optional[torch.Tensor] = None,
                     pcph_phase: Optional[torch.Tensor] = None):
    """(metrics, (target |S| images, predicted |S| images))."""
    mel, _, energy = ctx.mel_and_energy(batch["audio_gt"])
    pred = ctx.apply(
        state, "speech_predictor", batch["text"], batch["text_length"],
        batch["alignment"], batch["pitch"], energy, batch["audio_gt"],
        sample=sample, generator=generator, pcph_noise=pcph_noise,
        pcph_phase=pcph_phase)
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


STAGES["acoustic"] = StageType(
    compute_losses=_acoustic_losses,
    train_models=["speech_predictor", "pitch_energy_predictor",
                  "pe_text_encoder", "pe_mel_style_encoder"],
    discriminators=["mrd"],
)


def gan_losses(mrd: nn.Module, t_fft, p_fft,
               dtype: torch.dtype = torch.bfloat16):
    """(generator loss, discriminator total, plain LSGAN part) from the
    two views of the MRD, both in ``dtype`` (the step's is bf16).  The
    generator view runs on detached parameters, so its gradient reaches the
    predicted images and never the MRD; the discriminator view runs on
    detached images, so its gradient reaches the MRD and never the
    generator."""
    targets = [t.detach() for t in t_fft]
    g_rs, g_gs, g_rf, g_gf = run_cast(mrd, dtype, targets, list(p_fft),
                                      detach=True)
    gen_loss = L.generator_adversarial_loss(g_rs, g_gs, g_rf, g_gf)
    d_rs, d_gs, _, _ = run_cast(mrd, dtype, targets,
                                [p.detach() for p in p_fft])
    d_total, d_plain = L.discriminator_loss(d_rs, d_gs)
    return gen_loss, d_total, d_plain


def make_train_step(stage_name: str, ctx: StageContext, base_lr: float):
    """step(state, batch, generator, *, sample=True, pcph_noise=None,
    pcph_phase=None) -> (state, metrics).

    ``generator`` (on the batch's device) draws the dropout masks and the
    prior, posterior and harmonic-prior noise.  ``sample=False`` takes the
    latent means instead of samples; ``pcph_noise``/``pcph_phase`` hand the
    harmonic prior its noise and phase."""
    stage = STAGES[stage_name]
    has_disc = bool(stage.discriminators)

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None, **hooks):
        for key in stage.train_models:
            state.models[key].train()
            set_dropout_generator(state.models[key], generator)
        for key in stage.train_models + stage.discriminators:
            state.optimizers[key].zero_grad(set_to_none=True)
        batch_size = batch["text"].shape[0]
        try:
            metrics, disc_inputs = stage.compute_losses(
                ctx, state, batch, generator=generator, **hooks)
        finally:
            for key in stage.train_models:
                state.models[key].eval()
        if has_disc:
            t_fft, p_fft = disc_inputs
            gen_loss, d_total, d_plain = gan_losses(
                state.models["mrd"], t_fft, p_fft)
            metrics["generator"] = gen_loss
        total = backwards_loss(metrics, ctx.weights)
        if has_disc:
            total = total + d_total * math.sqrt(batch_size)
        total.backward()

        lr = cosine_logical_lr(base_lr, state.step, ctx.step_limit)
        for key in stage.train_models:
            apply_updates(state.optimizers[key], lr)
        if has_disc:
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
