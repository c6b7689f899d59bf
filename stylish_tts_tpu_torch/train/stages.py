"""Stage steps of the four-stage chain, acoustic -> textual -> style ->
duration, of the joint stage that fine-tunes the text-to-speech path end
to end, of the alignment stage that trains the CTC aligner on its own, and
of the three experimental stages on frozen HuBERT and speaker features
(``hubert_acoustic``, ``cfm_hubert_pitch``, ``cfm_hubert_mel``): each
stage's losses, the generic train step, the eval step and the alignment
stage's epoch end.

``make_train_step(stage, ctx, base_lr)`` returns
``step(state, batch, generator) -> (state, metrics)``, with the JAX
package's metric names.  One step runs the stage's losses, for the stages
with the MRD discriminator (acoustic, textual, joint) also the two GAN views of
the MRD, one backward of the total, and one AdamW update per trained
module: at the cosine LR, the MRD at that LR times the gap-aware
multiplier of its loss EMA.  The models a stage only evaluates pass
gradients to the trained ones through their activations, but take none
themselves: the step turns their parameters' ``requires_grad`` off.  The
state is updated in place.

``make_eval_step(stage, ctx)`` returns
``step(state, batch, generator) -> (metrics, audio_pred)``: the stage's
validation losses on its inference composition, under ``no_grad``, with
no state change.

Mixed precision follows the JAX package's casts, not ``torch.autocast``:
with ``mixed_precision == "bf16"`` each module runs on bf16 copies of its
f32 master parameters and on bf16 inputs, and its outputs return to f32;
the STFT chains, the losses and the optimizer stay f32; the MRD always
runs in bf16; the frozen SLM runs in bf16; the text aligner and the CFM
pitch predictor always run in f32 (``MIXED_PRECISION_EXEMPT``).  The
frozen HuBERT and speaker nets run in f32 under ``no_grad``, and the CFM
mel decoder always runs in f32 (the JAX package applies both outside its
casts).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from .. import losses as L
from ..config import Config, ModelConfig
from ..duration import DurationProcessor
from ..models.cfm_mel_decoder import CfmMelDecoderWrapper
from ..models.norms import set_dropout_generator
from ..models.vocos import VOCOS_HOP, VOCOS_N_FFT, vocos_mel
from ..ops import ctc as ctc_ops
from ..ops.griffin_lim import mel_to_audio
from ..ops.mel import MelSpectrogram, calculate_mel, log_norm_energy
from ..ops.multi_spectrogram import MultiSpectrogram
from ..ops.resample import resample
from .loss_log import backwards_loss, weighted_total
from .optim import apply_updates, cosine_logical_lr
from .state import TrainState

# modules that stay f32 under mixed precision: the aligner's CTC chain
# needs full-precision log-probs; in the CFM pitch predictor the mel style
# encoder's f32 vector (its spectral norms divide by f32 buffers) promotes
# every block after the first AdaLN to f32 in the JAX package, so the port
# runs the whole model in f32
MIXED_PRECISION_EXEMPT = frozenset({"text_aligner", "cfm_pitch_predictor"})
# Euler steps of the CFM mel decoder's validation solve
CFM_EVAL_STEPS = 16


def _interp_frames(x: torch.Tensor, n_out: int) -> torch.Tensor:
    """Linear resample [B, F_in] -> [B, n_out] along the frame axis."""
    f_in = x.shape[1]
    pos = torch.arange(n_out, device=x.device) * (f_in / n_out)
    lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, f_in - 1)
    hi = torch.clamp(lo + 1, 0, f_in - 1)
    w = (pos - lo).to(x.dtype)
    return x[:, lo] * (1.0 - w) + x[:, hi] * w


def norm_f0_zscore(f0, unvoiced, mean: float, std: float) -> torch.Tensor:
    """log2 z-scored F0, unvoiced frames at 0."""
    normed = (torch.log2(f0 + 1e-8) - mean) / std
    return torch.where(unvoiced, torch.zeros_like(normed), normed)


def denorm_f0_zscore(normed, unvoiced, mean: float, std: float,
                     min_hz: float = 50.0, max_hz: float = 1200.0
                     ) -> torch.Tensor:
    f0 = torch.clamp(2.0 ** (normed * std + mean), min_hz, max_hz)
    return torch.where(unvoiced, torch.zeros_like(f0), f0)


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
    # per duration class, from the dataset's alignments (duration stage)
    duration_class_weight: Optional[torch.Tensor] = None
    # frozen (AdaptiveHubert, SpeakerEmbeddingModel) of the hubert/CFM
    # stages, and the Vocos decoder of the CFM mel validation
    ssl: Optional[Tuple[nn.Module, nn.Module]] = None
    vocos: Optional[nn.Module] = None
    # the dataset's log2-F0 statistics (the CFM pitch target)
    f0_log2_mean: float = 7.0
    f0_log2_std: float = 1.0
    weights: Dict[str, float] = field(init=False)

    def __post_init__(self):
        mc = self.model_config
        self.to_mel = MelSpectrogram(
            n_mels=mc.n_mels, n_fft=mc.n_fft, win_length=mc.win_length,
            hop_length=mc.hop_length, sample_rate=mc.sample_rate)
        # the aligner's input: 80 bins whatever n_mels is
        self.to_align_mel = MelSpectrogram(
            n_mels=80, n_fft=mc.n_fft, win_length=mc.win_length,
            hop_length=mc.hop_length, sample_rate=mc.sample_rate)
        self.multi_spectrogram = MultiSpectrogram(mc.sample_rate)
        self.duration_processor = DurationProcessor(
            mc.duration_predictor.duration_classes,
            mc.duration_predictor.max_duration)
        self.weights = dataclasses.asdict(self.config.loss_weight)
        self.compute_dtype = (
            torch.bfloat16 if self.config.training.mixed_precision == "bf16"
            else torch.float32)
        if self.slm is not None:
            self.slm = self.slm.to(torch.bfloat16)

    def apply(self, state: TrainState, key: str, *args, **kwargs):
        """Run model ``key`` in the compute type of the config (f32 for
        the exempt modules)."""
        module = state.models[key]
        if (self.compute_dtype == torch.bfloat16
                and key not in MIXED_PRECISION_EXEMPT):
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

    def cfm_mel_features(self, audio_gt: torch.Tensor, pitch: torch.Tensor):
        """(normed mel, energy, pitch at its frames) in the configured CFM
        feature space: the model's mel, or with ``cfm_mel_features ==
        "vocos"`` Vocos's 100-bin hop-256 mel normalised by the dataset's
        stats, the pitch resampled linearly onto its frames."""
        if self.model_config.cfm_mel_features == "vocos":
            mel = (vocos_mel(audio_gt) - self.mel_mean) / self.mel_std
            energy = log_norm_energy(mel, self.mel_mean, self.mel_std)
            return mel, energy.detach(), _interp_frames(pitch, mel.shape[1])
        mel, _, energy = self.mel_and_energy(audio_gt)
        return mel, energy, pitch[:, :mel.shape[1]]

    @torch.no_grad()
    def ssl_features(self, audio_gt: torch.Tensor, time_dim: int):
        """The frozen HuBERT features at ``time_dim`` frames and the
        speaker vector, in f32."""
        hubert, speaker = self.ssl
        audio = audio_gt.float()
        return hubert(audio, time_dim), speaker(audio)

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
    next_stage: Optional[str]
    compute_losses: Callable
    train_models: List[str]
    # models the stage runs but does not train: gradients pass through
    # their activations, never into their parameters
    eval_models: List[str]
    discriminators: List[str]
    # the batch keys the stage reads (the memory probe's synthetic batch)
    inputs: List[str]
    # models whose dropout is on in the stage's losses (the JAX package's
    # ``train=True``); the trained models unless named
    dropout_models: Optional[List[str]] = None
    # the step accumulates the CTC label priors (``end_alignment_epoch``)
    uses_priors: bool = False

    def __post_init__(self):
        if self.dropout_models is None:
            self.dropout_models = list(self.train_models)

    @property
    def models(self) -> List[str]:
        """Every model the stage's train step runs or updates."""
        return list(dict.fromkeys(self.train_models + self.eval_models
                                  + self.discriminators))


STAGES: Dict[str, StageType] = {}
INPUTS = ["text", "text_length", "audio_gt", "pitch", "alignment"]


def _speech(ctx: StageContext, state: TrainState, batch, alignment, pitch,
            energy, audio_gt=None, *, sample: bool = True,
            generator: Optional[torch.Generator] = None,
            pcph_noise: Optional[torch.Tensor] = None,
            pcph_phase: Optional[torch.Tensor] = None):
    """The speech predictor on the batch's text: prior (and, with
    ``audio_gt``, posterior) samples and the harmonic prior's noise from
    ``generator`` or the hooks."""
    return ctx.apply(
        state, "speech_predictor", batch["text"], batch["text_length"],
        alignment, pitch, energy, audio_gt, sample=sample,
        generator=generator, pcph_noise=pcph_noise, pcph_phase=pcph_phase)


def _spectral_losses(ctx: StageContext, batch, pred):
    """The mel, mag and phase losses of a predicted waveform, and the
    |S| images the MRD compares."""
    t_mag, p_mag, _, _, t_fft, p_fft = ctx.multi_spectrogram(
        target=batch["audio_gt"], pred=pred.audio)
    mag_l, phase_l = L.magphase_loss(pred.magnitude, pred.phase,
                                     batch["audio_gt"],
                                     **ctx.magphase_params())
    return {"mel": L.multi_resolution_stft_loss(t_mag, p_mag),
            "mag": mag_l, "phase": phase_l}, (t_fft, p_fft)


def _acoustic_losses(ctx: StageContext, state: TrainState, batch, **hooks):
    """(metrics, (target |S| images, predicted |S| images))."""
    mel, _, energy = ctx.mel_and_energy(batch["audio_gt"])
    pred = _speech(ctx, state, batch, batch["alignment"], batch["pitch"],
                   energy, batch["audio_gt"], **hooks)
    pe_enc, _, _ = ctx.apply(state, "pe_text_encoder", batch["text"],
                             batch["text_length"])
    pe_mel_style = ctx.apply(state, "pe_mel_style_encoder", mel,
                             update_stats=True)
    pred_pitch, pred_energy = ctx.apply(
        state, "pitch_energy_predictor", pe_enc, batch["text_length"],
        batch["alignment"], pe_mel_style)
    spectral, images = _spectral_losses(ctx, batch, pred)
    metrics = {
        "mel": spectral["mel"],
        "slm": ctx.slm_loss(batch["audio_gt"], pred.audio),
        "mag": spectral["mag"],
        "phase": spectral["phase"],
        "pitch": L.smooth_l1_loss(pred_pitch, batch["pitch"]),
        "energy": L.smooth_l1_loss(pred_energy, energy),
    }
    return metrics, images


def _textual_losses(ctx: StageContext, state: TrainState, batch, **hooks):
    """The pitch/energy branch trained through the frozen speech
    predictor: its predicted F0 and energy drive the synthesis whose
    spectra the losses and the MRD compare."""
    mel, _, energy = ctx.mel_and_energy(batch["audio_gt"])
    pe_enc, _, _ = ctx.apply(state, "pe_text_encoder", batch["text"],
                             batch["text_length"])
    pe_mel_style = ctx.apply(state, "pe_mel_style_encoder", mel,
                             update_stats=True)
    pred_pitch, pred_energy = ctx.apply(
        state, "pitch_energy_predictor", pe_enc, batch["text_length"],
        batch["alignment"], pe_mel_style)
    pred = _speech(ctx, state, batch, batch["alignment"], pred_pitch,
                   pred_energy, **hooks)
    spectral, images = _spectral_losses(ctx, batch, pred)
    metrics = {
        **spectral,
        "pitch": L.smooth_l1_loss(pred_pitch, batch["pitch"]),
        "energy": L.smooth_l1_loss(pred_energy, energy),
    }
    return metrics, images


def _style_losses(ctx: StageContext, state: TrainState, batch, **hooks):
    """The text style encoder against the mel style encoder's vector, and
    the pitch/energy the text style gives."""
    mel, _, energy = ctx.mel_and_energy(batch["audio_gt"])
    pe_enc, _, _ = ctx.apply(state, "pe_text_encoder", batch["text"],
                             batch["text_length"])
    pe_text_style = ctx.apply(state, "pe_text_style_encoder", pe_enc,
                              batch["text_length"])
    pe_mel_style = ctx.apply(state, "pe_mel_style_encoder", mel)
    pred_pitch, pred_energy = ctx.apply(
        state, "pitch_energy_predictor", pe_enc, batch["text_length"],
        batch["alignment"], pe_text_style)
    metrics = {
        "style": L.smooth_l1_loss(pe_text_style, pe_mel_style) * 10.0,
        "pitch": L.smooth_l1_loss(pred_pitch, batch["pitch"]),
        "energy": L.smooth_l1_loss(pred_energy, energy),
    }
    return metrics, None


def _duration_losses(ctx: StageContext, state: TrainState, batch, **hooks):
    """Class-weighted cross entropy and class-distance loss of the
    duration predictor against the alignment's durations."""
    targets = ctx.duration_processor.align_to_class(batch["alignment"])
    pred = ctx.apply(state, "duration_predictor", batch["text"],
                     batch["text_length"])
    ce, cdw = L.duration_loss(pred, targets, batch["text_length"],
                              ctx.duration_class_weight)
    return {"duration_ce": ce, "duration": cdw}, None


def _joint_losses(ctx: StageContext, state: TrainState, batch, **hooks):
    """The text-to-speech path trained end to end: the text style vector
    drives the predicted pitch and energy, which drive the speech
    predictor (on the ground-truth alignment, with its posterior), so the
    spectral, SLM and GAN terms reach the pitch/energy branch and the text
    encoder through them.  The mel style encoder only reads its stored
    spectral-norm vectors and gives the style term its target."""
    mel, _, energy = ctx.mel_and_energy(batch["audio_gt"])
    pe_mel_style = ctx.apply(state, "pe_mel_style_encoder", mel)
    pe_enc, _, _ = ctx.apply(state, "pe_text_encoder", batch["text"],
                             batch["text_length"])
    pe_text_style = ctx.apply(state, "pe_text_style_encoder", pe_enc,
                              batch["text_length"])
    pred_pitch, pred_energy = ctx.apply(
        state, "pitch_energy_predictor", pe_enc, batch["text_length"],
        batch["alignment"], pe_text_style)
    pred = _speech(ctx, state, batch, batch["alignment"], pred_pitch,
                   pred_energy, batch["audio_gt"], **hooks)
    spectral, images = _spectral_losses(ctx, batch, pred)
    metrics = {
        "mel": spectral["mel"],
        "slm": ctx.slm_loss(batch["audio_gt"], pred.audio),
        "mag": spectral["mag"],
        "phase": spectral["phase"],
        "style": L.smooth_l1_loss(pe_text_style, pe_mel_style) * 10.0,
        "pitch": L.smooth_l1_loss(pred_pitch, batch["pitch"]),
        "energy": L.smooth_l1_loss(pred_energy, energy),
    }
    return metrics, images


def _alignment_losses(ctx: StageContext, state: TrainState, batch, **hooks):
    """(metrics, (the batch's emission log-sums [C], its frame count)):
    CTC loss of the aligner on the 80-bin mel, less 0.3 x the label
    priors once an epoch's end has set them."""
    mel, mel_length = calculate_mel(batch["audio_gt"], ctx.to_align_mel,
                                    ctx.mel_mean, ctx.mel_std)
    log_probs, _ = ctx.apply(state, "text_aligner", mel, mel_length)
    priors = state.priors
    log_priors = torch.where(priors["priors_initialized"],
                             priors["log_priors"],
                             torch.zeros_like(priors["log_priors"]))
    loss, prior_sum, n_frames = ctc_ops.ctc_loss_with_priors(
        log_probs, batch["text"], mel_length, batch["text_length"],
        ctx.model_config.text_encoder.tokens, log_priors)
    return {"align_loss": loss}, (prior_sum, n_frames)


def _hubert_acoustic_losses(ctx: StageContext, state: TrainState, batch,
                            **hooks):
    """The acoustic losses with the frozen HuBERT features in place of the
    aligned text and the speaker vector in place of the style: the hubert
    speech predictor (with its posterior and flow terms) on the ground-truth
    pitch, and the hubert pitch/energy predictor."""
    mel, mel_length, energy = ctx.mel_and_energy(batch["audio_gt"])
    phones, spk_emb = ctx.ssl_features(batch["audio_gt"], mel.shape[1])
    pred = ctx.apply(state, "hubert_speech_predictor", phones, mel_length,
                     spk_emb, batch["pitch"][:, :mel.shape[1]], energy,
                     batch["audio_gt"], **hooks)
    pred_pitch, pred_energy = ctx.apply(
        state, "hubert_pitch_energy_predictor", phones, mel_length, spk_emb)
    spectral, images = _spectral_losses(ctx, batch, pred)
    metrics = {
        "mel": spectral["mel"],
        "slm": ctx.slm_loss(batch["audio_gt"], pred.audio),
        "mag": spectral["mag"],
        "phase": spectral["phase"],
        "pitch": L.smooth_l1_loss(
            pred_pitch, batch["pitch"][:, :pred_pitch.shape[1]]),
        "energy": L.smooth_l1_loss(pred_energy, energy),
    }
    metrics.update(L.normalizing_flow_losses(pred))
    return metrics, images


def _cfm_mel_losses(ctx: StageContext, state: TrainState, batch,
                    generator: Optional[torch.Generator] = None,
                    cfm_draws: Optional[dict] = None, **hooks):
    """The OT-CFM loss of the mel decoder (in f32) on the frozen features:
    t, z, the condition-drop uniforms, the TREAD route and the sine
    source's noise from ``generator``, or from ``cfm_draws``."""
    mel, energy, pitch = ctx.cfm_mel_features(batch["audio_gt"],
                                              batch["pitch"])
    phones, spk_emb = ctx.ssl_features(batch["audio_gt"], mel.shape[1])
    decoder = state.models["cfm_mel_decoder"]
    conds = dict(asr=phones, f0=pitch, energy=energy, spk_emb=spk_emb)
    draws = cfm_draws
    if draws is None:
        draws = decoder.draw(mel.shape[0], mel.shape[1], mel.device,
                             generator)
    sampler = CfmMelDecoderWrapper(decoder, draws).sampler()
    if cfm_draws is None:
        draws.update(sampler.draw(mel, conds, generator))
    pred, target = sampler.compute_pred_target(mel, draws=draws, **conds)
    return {"mel_l2": torch.mean((pred - target) ** 2)}, None


def _cfm_pitch_losses(ctx: StageContext, state: TrainState, batch,
                      **hooks):
    """MSE of the CFM pitch predictor against the log2 z-scored F0
    (unvoiced frames at 0), from the frozen HuBERT features at the pitch
    track's frames and the model's mel."""
    mel, _, _ = ctx.mel_and_energy(batch["audio_gt"])
    phones, _ = ctx.ssl_features(batch["audio_gt"], batch["pitch"].shape[1])
    f0 = batch["pitch"]
    normed = norm_f0_zscore(f0, f0 == 0, ctx.f0_log2_mean, ctx.f0_log2_std)
    pred = ctx.apply(state, "cfm_pitch_predictor", phones, mel)
    return {"normed_pitch_l2": torch.mean(
        (pred[:, :normed.shape[1]] - normed) ** 2)}, None


STAGES["alignment"] = StageType(
    next_stage=None,
    compute_losses=_alignment_losses,
    train_models=["text_aligner"],
    eval_models=[],
    discriminators=[],
    inputs=["text", "text_length", "audio_gt"],
    uses_priors=True,
)
STAGES["acoustic"] = StageType(
    next_stage="textual",
    compute_losses=_acoustic_losses,
    train_models=["speech_predictor", "pitch_energy_predictor",
                  "pe_text_encoder", "pe_mel_style_encoder"],
    eval_models=[],
    discriminators=["mrd"],
    inputs=INPUTS,
)
STAGES["textual"] = StageType(
    next_stage="style",
    compute_losses=_textual_losses,
    train_models=["pitch_energy_predictor", "pe_text_encoder",
                  "pe_mel_style_encoder"],
    eval_models=["speech_predictor"],
    discriminators=["mrd"],
    inputs=INPUTS,
)
STAGES["style"] = StageType(
    next_stage="duration",
    compute_losses=_style_losses,
    train_models=["pe_text_style_encoder"],
    eval_models=["pe_mel_style_encoder", "pitch_energy_predictor",
                 "pe_text_encoder", "speech_predictor"],
    discriminators=[],
    inputs=INPUTS,
    dropout_models=["pe_text_style_encoder", "pe_text_encoder",
                    "pitch_energy_predictor"],
)
STAGES["duration"] = StageType(
    next_stage=None,
    compute_losses=_duration_losses,
    train_models=["duration_predictor"],
    eval_models=["pitch_energy_predictor", "speech_predictor",
                 "pe_text_encoder", "pe_text_style_encoder"],
    discriminators=[],
    inputs=["text", "text_length", "alignment", "audio_gt"],
)
STAGES["joint"] = StageType(
    next_stage=None,
    compute_losses=_joint_losses,
    train_models=["pe_text_style_encoder", "pitch_energy_predictor",
                  "pe_text_encoder", "speech_predictor"],
    eval_models=["pe_mel_style_encoder"],
    discriminators=["mrd"],
    inputs=INPUTS,
)

STAGES["hubert_acoustic"] = StageType(
    next_stage=None,
    compute_losses=_hubert_acoustic_losses,
    train_models=["hubert_speech_predictor", "hubert_pitch_energy_predictor"],
    eval_models=[],
    discriminators=["mrd"],
    inputs=INPUTS,
)
# the hubert encoder is listed as trained but no loss applies it: AdamW's
# decoupled decay alone moves it, as in the JAX package
STAGES["cfm_hubert_mel"] = StageType(
    next_stage=None,
    compute_losses=_cfm_mel_losses,
    train_models=["cfm_mel_decoder", "hubert_encoder"],
    eval_models=[],
    discriminators=[],
    inputs=INPUTS,
)
STAGES["cfm_hubert_pitch"] = StageType(
    next_stage=None,
    compute_losses=_cfm_pitch_losses,
    train_models=["cfm_pitch_predictor"],
    eval_models=[],
    discriminators=[],
    inputs=INPUTS,
)
# the stages on the frozen HuBERT and speaker nets
SSL_STAGES = ("hubert_acoustic", "cfm_hubert_pitch", "cfm_hubert_mel")


def check_stage(name: str) -> StageType:
    """The stage ``name``; raises for a name that is no stage."""
    if name in STAGES:
        return STAGES[name]
    raise ValueError(f"invalid stage {name!r}; valid: {list(STAGES)}")


def chain_models(first: str) -> List[str]:
    """Every model that the stages from ``first`` to the end of its chain
    train, evaluate or discriminate with, in order of first use."""
    keys: List[str] = []
    name: Optional[str] = first
    while name is not None:
        stage = check_stage(name)
        keys += [k for k in stage.models if k not in keys]
        name = stage.next_stage
    return keys


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


def _set_trainable(state: TrainState, trained: List[str]) -> None:
    """Parameters of ``trained`` take gradients, every other model's do
    not (a model's flag is switched only where it differs)."""
    for key, module in state.models.items():
        want = key in trained
        first = next(module.parameters(), None)
        if first is not None and first.requires_grad != want:
            module.requires_grad_(want)


def make_train_step(stage_name: str, ctx: StageContext, base_lr: float):
    """step(state, batch, generator, *, sample=True, pcph_noise=None,
    pcph_phase=None) -> (state, metrics).

    ``generator`` (on the batch's device) draws the dropout masks and the
    prior, posterior and harmonic-prior noise.  ``sample=False`` takes the
    latent means instead of samples; ``pcph_noise``/``pcph_phase`` hand the
    harmonic prior its noise and phase."""
    stage = check_stage(stage_name)
    has_disc = bool(stage.discriminators)
    updated = stage.train_models + stage.discriminators

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None, **hooks):
        _set_trainable(state, updated)
        for key in stage.dropout_models:
            state.models[key].train()
            set_dropout_generator(state.models[key], generator)
        for key in updated:
            state.optimizers[key].zero_grad(set_to_none=True)
        batch_size = batch["text"].shape[0]
        try:
            # the second value: the MRD's inputs for the GAN stages, the
            # batch's prior accumulators where the stage uses priors
            metrics, extra = stage.compute_losses(
                ctx, state, batch, generator=generator, **hooks)
        finally:
            for key in stage.dropout_models:
                state.models[key].eval()
        if has_disc:
            t_fft, p_fft = extra
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
        if stage.uses_priors:
            prior_sum, n_frames = extra
            priors = state.priors
            priors["prior_sum"] = torch.logaddexp(priors["prior_sum"],
                                                  prior_sum)
            priors["prior_frames"] = priors["prior_frames"] + n_frames
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = weighted_total(metrics, ctx.weights)
        return state, metrics

    return step


def make_eval_step(stage_name: str, ctx: StageContext):
    """step(state, batch, generator, *, sample=True, pcph_noise=None,
    pcph_phase=None) -> (metrics, audio_pred).

    The stage's validation on its inference composition, under
    ``no_grad`` with every model in eval mode; nothing in the state
    changes.  ``alignment`` gives the aligner's CTC loss (no priors) and
    ``confidence``, the mean probability of the forced alignment's states
    over the valid frames, and no audio.  ``acoustic`` synthesizes from the
    ground-truth pitch and energy, ``textual``, ``style`` and ``joint``
    from the predicted ones (``style`` and ``joint`` with the text style
    vector, and a ``style`` metric); ``duration`` runs the whole inference
    path: predicted durations -> alignment at the batch's frame count ->
    pitch and energy -> speech.  ``hubert_acoustic`` synthesizes from the
    frozen features and the ground-truth pitch, ``cfm_hubert_pitch``
    predicts the normalised F0, ``cfm_hubert_mel`` solves the CFM ODE in
    ``CFM_EVAL_STEPS`` Euler steps from noise and auditions the mel through
    Vocos (Vocos features and weights given) or Griffin-Lim.  The speech
    predictor's noise comes from ``generator`` or the hooks; the CFM
    solve's noise, its sine source's noise and Griffin-Lim's phase from
    ``generator`` or ``cfm_draws`` ({"z", "noise", "phase"})."""
    check_stage(stage_name)

    @torch.no_grad()
    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None, **hooks):
        for module in state.models.values():
            module.eval()
        text, lengths = batch["text"], batch["text_length"]
        if stage_name in SSL_STAGES:
            metrics, audio = _ssl_eval(stage_name, ctx, state, batch,
                                       generator, **hooks)
        elif stage_name == "alignment":
            mel, mel_length = calculate_mel(
                batch["audio_gt"], ctx.to_align_mel, ctx.mel_mean,
                ctx.mel_std)
            log_probs, _ = ctx.apply(state, "text_aligner", mel, mel_length)
            blank = ctx.model_config.text_encoder.tokens
            loss = ctc_ops.ctc_loss(log_probs, text, mel_length, lengths,
                                    blank)
            _, scores = ctc_ops.forced_align(log_probs, text, mel_length,
                                             lengths, blank)
            valid = (torch.arange(scores.shape[1], device=scores.device)
                     [None] < mel_length[:, None])
            confidence = (torch.exp(scores) * valid).sum() / valid.sum()
            metrics = {"align_loss": loss, "confidence": confidence}
            audio = None
        elif stage_name == "duration":
            targets = ctx.duration_processor.align_to_class(
                batch["alignment"])
            pred = ctx.apply(state, "duration_predictor", text, lengths)
            ce, cdw = L.duration_loss(pred, targets, lengths,
                                      ctx.duration_class_weight)
            metrics = {"duration_ce": ce, "duration": cdw}
            dp = ctx.duration_processor
            durs = dp.prediction_to_duration(pred)
            token_mask = (torch.arange(durs.shape[1], device=durs.device)
                          [None, :] < lengths[:, None])
            durs = torch.where(token_mask, durs, torch.zeros_like(durs))
            alignment = dp.batched_duration_to_alignment(
                durs, batch["alignment"].shape[-1])
            pe_enc, _, _ = ctx.apply(state, "pe_text_encoder", text, lengths)
            style = ctx.apply(state, "pe_text_style_encoder", pe_enc, lengths)
            pitch, energy = ctx.apply(state, "pitch_energy_predictor",
                                      pe_enc, lengths, alignment, style)
            audio = _speech(ctx, state, batch, alignment, pitch, energy,
                            generator=generator, **hooks).audio
        else:
            mel, _, energy = ctx.mel_and_energy(batch["audio_gt"])
            pe_enc, _, _ = ctx.apply(state, "pe_text_encoder", text, lengths)
            pe_mel_style = ctx.apply(state, "pe_mel_style_encoder", mel)
            text_style = stage_name in ("style", "joint")
            style = (ctx.apply(state, "pe_text_style_encoder", pe_enc,
                               lengths)
                     if text_style else pe_mel_style)
            pred_pitch, pred_energy = ctx.apply(
                state, "pitch_energy_predictor", pe_enc, lengths,
                batch["alignment"], style)
            if stage_name == "acoustic":
                pitch, use_energy = batch["pitch"], energy
            else:
                pitch, use_energy = pred_pitch, pred_energy
            pred = _speech(ctx, state, batch, batch["alignment"], pitch,
                           use_energy, generator=generator, **hooks)
            t_mag, p_mag, _, _, _, _ = ctx.multi_spectrogram(
                target=batch["audio_gt"], pred=pred.audio)
            metrics = {
                "mel": L.multi_resolution_stft_loss(t_mag, p_mag),
                "pitch": L.smooth_l1_loss(pred_pitch, batch["pitch"]),
                "energy": L.smooth_l1_loss(pred_energy, energy),
            }
            if text_style:
                metrics["style"] = L.smooth_l1_loss(style,
                                                    pe_mel_style) * 10.0
            audio = pred.audio
        metrics["loss"] = weighted_total(metrics, ctx.weights)
        return metrics, audio

    return step


def _ssl_eval(stage_name: str, ctx: StageContext, state: TrainState,
              batch, generator: Optional[torch.Generator] = None,
              cfm_draws: Optional[dict] = None, **hooks):
    """(metrics, audio or None) of an experimental stage's validation."""
    audio_gt = batch["audio_gt"]
    if stage_name == "hubert_acoustic":
        mel, mel_length, energy = ctx.mel_and_energy(audio_gt)
        phones, spk_emb = ctx.ssl_features(audio_gt, mel.shape[1])
        pred = ctx.apply(state, "hubert_speech_predictor", phones,
                         mel_length, spk_emb,
                         batch["pitch"][:, :mel.shape[1]], energy, None,
                         generator=generator, **hooks)
        pred_pitch, pred_energy = ctx.apply(
            state, "hubert_pitch_energy_predictor", phones, mel_length,
            spk_emb)
        t_mag, p_mag, _, _, _, _ = ctx.multi_spectrogram(target=audio_gt,
                                                         pred=pred.audio)
        return {
            "mel": L.multi_resolution_stft_loss(t_mag, p_mag),
            "pitch": L.smooth_l1_loss(
                pred_pitch, batch["pitch"][:, :pred_pitch.shape[1]]),
            "energy": L.smooth_l1_loss(pred_energy, energy),
        }, pred.audio
    if stage_name == "cfm_hubert_pitch":
        mel, _, _ = ctx.mel_and_energy(audio_gt)
        phones, _ = ctx.ssl_features(audio_gt, batch["pitch"].shape[1])
        f0 = batch["pitch"]
        normed = norm_f0_zscore(f0, f0 == 0, ctx.f0_log2_mean,
                                ctx.f0_log2_std)
        pred = ctx.apply(state, "cfm_pitch_predictor", phones, mel)
        return {"normed_pitch_l2": torch.mean(
            (pred[:, :normed.shape[1]] - normed) ** 2)}, None
    # cfm_hubert_mel
    mc = ctx.model_config
    mel, energy, pitch = ctx.cfm_mel_features(audio_gt, batch["pitch"])
    phones, spk_emb = ctx.ssl_features(audio_gt, mel.shape[1])
    decoder = state.models["cfm_mel_decoder"]
    draws = cfm_draws or {}
    z = draws.get("z")
    if z is None:
        z = torch.randn(mel.shape, generator=generator, device=mel.device)
    noise = draws.get("noise")
    if noise is None:
        noise = decoder.draw(mel.shape[0], mel.shape[1], mel.device,
                             generator)["noise"]
    sampler = CfmMelDecoderWrapper(decoder, {"noise": noise}).sampler()
    mel_pred = sampler.sample(z, CFM_EVAL_STEPS, asr=phones, f0=pitch,
                              energy=energy, spk_emb=spk_emb)
    metrics = {"mel_l2": torch.mean((mel_pred - mel) ** 2),
               "mel_l1": torch.mean(torch.abs(mel_pred - mel))}
    vocos_space = mc.cfm_mel_features == "vocos"
    if vocos_space and ctx.vocos is not None:
        audio = ctx.vocos(mel_pred * ctx.mel_std + ctx.mel_mean)
    else:
        gl = (dict(n_fft=VOCOS_N_FFT, win_length=VOCOS_N_FFT,
                   hop_length=VOCOS_HOP, power=1.0) if vocos_space else
              dict(n_fft=mc.n_fft, win_length=mc.win_length,
                   hop_length=mc.hop_length))
        audio = mel_to_audio(mel_pred, sample_rate=mc.sample_rate,
                             mean=ctx.mel_mean, std=ctx.mel_std,
                             generator=generator, phase=draws.get("phase"),
                             **gl)
    return metrics, audio


@torch.no_grad()
def end_alignment_epoch(state: TrainState) -> TrainState:
    """Epoch-end CTC prior update, in place: the priors become the
    epoch's mean emission probabilities (log, clamped at -12), the
    accumulators restart and ``priors_initialized`` turns true.  One
    process: the JAX package's psum over the data axis comes with the
    mesh (Queue 1 item 6)."""
    priors = state.priors
    priors["log_priors"] = ctc_ops.update_log_priors(
        priors["prior_sum"], torch.log(priors["prior_frames"] + 1e-9))
    priors["prior_sum"] = torch.full_like(priors["prior_sum"], -1e30)
    priors["prior_frames"] = torch.zeros_like(priors["prior_frames"])
    priors["priors_initialized"] = torch.ones_like(
        priors["priors_initialized"])
    return state
