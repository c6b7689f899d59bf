"""The training models, their initialisation and the train state.

Parameters are drawn from an explicit ``torch.Generator`` with the
distributions of the JAX package's flax initialisers: lecun-normal
(truncated) weights, zero biases, unit norm scales, normal(hidden^-0.5)
token embeddings, zero-initialised prior/posterior/coupling heads and
prenet projection, standard-normal spectral-norm ``u``.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Union

import torch
from torch import nn

from ..config import ModelConfig
from ..device import resolve_device
from ..models import build_models
from ..models.discriminator import MultiResolutionDiscriminator
from ..models.slm import SLMFeatureExtractor
from ..models.speech_predictor import SpeechPredictor
from ..models.style_encoders import MelStyleEncoder
from ..models.text_aligner import build_text_aligner
from .optim import make_optimizer
from .state import TrainState, init_priors

# heads flax initialises to zero (kernel and bias)
ZERO_INIT = ("proj_mean", "proj_logstd", "prenet.proj")
# flax's truncated normal on [-2, 2] has this std; lecun scales by 1/it
_TRUNC_STD = 0.87962566103423978


def build_training_models(mc: ModelConfig) -> Dict[str, nn.Module]:
    """The inference models plus the training-only ones: the speech
    predictor with its posterior encoder, the mel style encoder, the MRD
    and the CTC text aligner.  Eval mode (dropout off, the aligner's batch
    norms on their running stats) until a step runs them."""
    models = build_models(mc)
    models["speech_predictor"] = SpeechPredictor(mc, posterior=True).eval()
    models["pe_mel_style_encoder"] = MelStyleEncoder(
        style_dim=mc.style_dim, dim_in=mc.n_mels,
        max_conv_dim=mc.mel_style_encoder.max_channels,
        skip_last_downsample=mc.mel_style_encoder.skip_downsample).eval()
    models["mrd"] = MultiResolutionDiscriminator(3).eval()
    models["text_aligner"] = build_text_aligner(mc)
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
    """The frozen SLM feature net, drawn from ``generator``."""
    slm = init_params(SLMFeatureExtractor(n_layers=mc.slm.layers), generator)
    slm.requires_grad_(False)
    return slm.eval()


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
    if models is None:
        if generator is None:
            raise ValueError("pass the models or a generator to draw them")
        built = build_training_models(mc)
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
