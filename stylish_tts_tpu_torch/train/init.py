"""The training models, their initialisation, the frozen feature nets and
the train state.

Parameters are drawn from an explicit ``torch.Generator`` with the
distributions of the JAX package's flax initialisers: lecun-normal
(truncated) weights, zero biases, unit norm scales, normal(hidden^-0.5)
token embeddings, zero-initialised prior/posterior/coupling heads, prenet
projection and AdaLN modulation heads, standard-normal spectral-norm
``u``, the axial RoPE's log-frequencies at their linspace.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Tuple, Union

import torch
from torch import nn

from ..config import ModelConfig
from ..convert import load_flax_params
from ..device import resolve_device
from ..models import INFERENCE_MODELS, build_models
from ..models.cfm_mel_decoder import CfmMelDecoder
from ..models.cfm_pitch_predictor import CfmPitchPredictor
from ..models.discriminator import MultiResolutionDiscriminator
from ..models.hubert_encoder import HubertEncoder
from ..models.hubert_speech_predictor import (HubertPitchEnergyPredictor,
                                              HubertSpeechPredictor)
from ..models.slm import SLMFeatureExtractor
from ..models.speech_predictor import SpeechPredictor
from ..models.ssl import AdaptiveHubert, SpeakerEmbeddingModel
from ..models.style_encoders import MelStyleEncoder
from ..models.text_aligner import build_text_aligner
from ..models.vocos import Vocos
from ..utils.tensorfile import read_safetensors
from .optim import make_optimizer
from .state import TrainState, init_priors

# heads flax initialises to zero (kernel and bias): the flow heads, the
# prenet projection, the XUT blocks' own AdaLN heads and the CFM mel
# decoder's shared modulations' last layer
ZERO_INIT = ("proj_mean", "proj_logstd", "prenet.proj", "adaln",
             "shared_attn.fc2", "shared_xattn.fc2", "shared_ffw.fc2")
# flax's truncated normal on [-2, 2] has this std; lecun scales by 1/it
_TRUNC_STD = 0.87962566103423978


def build_training_models(mc: ModelConfig,
                          keys: Optional[Iterable[str]] = None
                          ) -> Dict[str, nn.Module]:
    """The inference models plus the training-only ones: the speech
    predictor with its posterior encoder, the mel style encoder, the MRD,
    the CTC text aligner and the models of the experimental hubert/CFM
    stages (all of them, or those named in ``keys``).  Eval mode (dropout
    off, the aligner's batch norms on their running stats) until a step
    runs them."""
    feat_dim = 100 if mc.cfm_mel_features == "vocos" else mc.n_mels
    constructors = {
        "speech_predictor": lambda: SpeechPredictor(mc, posterior=True),
        "pe_mel_style_encoder": lambda: MelStyleEncoder(
            style_dim=mc.style_dim, dim_in=mc.n_mels,
            max_conv_dim=mc.mel_style_encoder.max_channels,
            skip_last_downsample=mc.mel_style_encoder.skip_downsample),
        "mrd": lambda: MultiResolutionDiscriminator(3),
        "text_aligner": lambda: build_text_aligner(mc),
        "hubert_encoder": lambda: HubertEncoder(mc),
        # the "vocos" feature space is Vocos's 100 bins at hop 256
        "cfm_mel_decoder": lambda: CfmMelDecoder(
            feat_dim=feat_dim, asr_dim=mc.hubert.hidden_dim,
            spk_dim=mc.speaker_embedder.hidden_dim,
            hidden_dim=mc.decoder.hidden_dim),
        "cfm_pitch_predictor": lambda: CfmPitchPredictor(
            asr_dim=mc.hubert.hidden_dim, n_mels=mc.n_mels),
        "hubert_speech_predictor": lambda: HubertSpeechPredictor(mc),
        "hubert_pitch_energy_predictor":
            lambda: HubertPitchEnergyPredictor(mc),
    }
    if keys is None:
        models = build_models(mc)
    else:
        keys = list(keys)
        models = ({k: m for k, m in build_models(mc).items() if k in keys}
                  if set(keys) & set(INFERENCE_MODELS) else {})
    for key, build in constructors.items():
        if keys is None or key in keys:
            models[key] = build().eval()
    return models


def _lecun_normal_(p: torch.Tensor, generator: torch.Generator) -> None:
    fan_in = p[0].numel()  # torch layout [out, in/g, *kernel]
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw every parameter and batch stat of ``module`` (CPU tensors)
    from ``generator``, in a fixed order."""
    embeddings = {f"{n}.weight" for n, m in module.named_modules()
                  if isinstance(m, nn.Embedding)}
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if any(f"{z}." in name for z in ZERO_INIT) or leaf in ("bias",
                                                               "beta"):
            p.zero_()
        elif name in embeddings:
            p.normal_(0.0, p.shape[1] ** -0.5, generator=generator)
        elif leaf == "rel_attn_embed":
            p.normal_(0.0, 0.02, generator=generator)
        elif leaf == "freqs":  # AxialRoPE [heads, half, pos_dim]
            p.copy_(torch.linspace(math.log(math.pi),
                                   math.log(5.0 * math.pi), p.shape[-1]))
        elif leaf in ("scale", "gru_rel_pos_const"):
            p.fill_(1.0)
        elif leaf == "gamma":  # ChannelLayerNorm's scale; GRN's gain is 0
            p.fill_(1.0 if p.dim() == 1 else 0.0)
        elif leaf == "weight" and p.dim() == 1:  # LayerNorm / GroupNorm
            p.fill_(1.0)
        elif leaf == "weight":
            _lecun_normal_(p, generator)
        else:
            raise ValueError(f"no initialiser for {name}")
    for name, b in module.named_buffers():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "u":
            b.normal_(0.0, 1.0, generator=generator)
        elif leaf in ("sigma", "var"):  # the aligner's batch norms: var 1
            b.fill_(1.0)
        elif leaf == "mean":
            b.zero_()
    return module


def init_slm(mc: ModelConfig, generator: torch.Generator
             ) -> SLMFeatureExtractor:
    """The frozen SLM feature net: converted WavLM weights from
    ``mc.slm.weights_path`` where it is set (the flat safetensors of flax
    names that the JAX package's ``save_model_safetensors`` writes; a name
    left unused or a parameter left unfilled raises), else drawn from
    ``generator``."""
    slm = SLMFeatureExtractor(n_layers=mc.slm.layers)
    if mc.slm.weights_path:
        slm.load_state_dict(load_flax_params(
            "slm", read_safetensors(mc.slm.weights_path), slm))
    else:
        init_params(slm, generator)
    slm.requires_grad_(False)
    return slm.eval()


def init_ssl(mc: ModelConfig, generator: torch.Generator
             ) -> Tuple[AdaptiveHubert, SpeakerEmbeddingModel]:
    """The frozen HuBERT and speaker nets of the hubert/CFM stages, drawn
    from ``generator``; ``hubert.weights_path`` fills the HuBERT encoder and
    ``speaker_embedder.weights_path`` the SimAM-ResNet34 (``xvector``),
    each a flat safetensors of the flax names (a name left unused or a
    parameter left unfilled raises)."""
    hubert = AdaptiveHubert(model_sr=mc.sample_rate, hubert_sr=mc.hubert.sr,
                            proj_dim=mc.hubert.hidden_dim)
    speaker = SpeakerEmbeddingModel(model_sr=mc.sample_rate,
                                    hidden_dim=mc.speaker_embedder.hidden_dim)
    for module, sub, path in (
            (hubert, "encoder", mc.hubert.weights_path),
            (speaker, "xvector", mc.speaker_embedder.weights_path)):
        init_params(module, generator)
        if path:
            part = getattr(module, sub)
            part.load_state_dict(load_flax_params(
                sub, read_safetensors(path), part))
        module.requires_grad_(False)
        module.eval()
    return hubert, speaker


def init_vocos(weights_path: Optional[str]) -> Optional[Vocos]:
    """The frozen Vocos decoder from converted weights (the flat
    safetensors of its flax names), or None where no file is named:
    validation then auditions through Griffin-Lim."""
    if not weights_path:
        return None
    vocos = Vocos()
    vocos.load_state_dict(load_flax_params(
        "vocos", read_safetensors(weights_path), vocos))
    vocos.requires_grad_(False)
    return vocos.eval()


def build_train_state(
    mc: ModelConfig,
    keys: Iterable[str],
    *,
    generator: Optional[torch.Generator] = None,
    models: Optional[Dict[str, nn.Module]] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> TrainState:
    """The train state of the models ``keys`` on ``device`` (the card
    unless the caller names another).  ``models`` carries given weights;
    otherwise every model is drawn from ``generator``."""
    device = resolve_device(device)
    keys = list(keys)
    if models is None:
        if generator is None:
            raise ValueError("pass the models or a generator to draw them")
        built = build_training_models(mc, keys)
        models = {k: init_params(built[k], generator) for k in keys}
    models = {k: models[k].to(device) for k in keys}
    return TrainState(
        models=models,
        optimizers={k: make_optimizer(m) for k, m in models.items()},
        disc_ema={"mrd": torch.tensor(1.5, dtype=torch.float32,
                                      device=device)},
        priors=init_priors(mc.text_encoder.tokens + 1, device),
        step=0,
    )
