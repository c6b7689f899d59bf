"""The reference's models, train state and synthesis, built from the
frozen copy in this folder: nothing of the program is imported."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from .config import ModelConfig
from .duration import DurationProcessor
from .models import build_models
from .models.discriminator import MultiResolutionDiscriminator
from .models.slm import SLMFeatureExtractor
from .models.speech_predictor import SpeechPredictor
from .models.style_encoders import MelStyleEncoder
from .train.optim import make_optimizer
from .train.stages import DISCRIMINATORS, TRAIN_MODELS
from .train.state import TrainState

DISC_EMA_INIT = 1.5  # the MRD's plain-loss EMA at the start of a run


def training_models(mc: ModelConfig) -> Dict[str, nn.Module]:
    """The acoustic stage's trained models and the MRD, in eval mode."""
    models = {
        "speech_predictor": SpeechPredictor(mc, posterior=True),
        "pitch_energy_predictor": build_models(mc)["pitch_energy_predictor"],
        "pe_text_encoder": build_models(mc)["pe_text_encoder"],
        "pe_mel_style_encoder": MelStyleEncoder(
            style_dim=mc.style_dim, dim_in=mc.n_mels,
            max_conv_dim=mc.mel_style_encoder.max_channels,
            skip_last_downsample=mc.mel_style_encoder.skip_downsample),
        "mrd": MultiResolutionDiscriminator(3),
    }
    assert list(models) == TRAIN_MODELS + DISCRIMINATORS
    return {k: m.eval() for k, m in models.items()}


def inference_models(mc: ModelConfig) -> Dict[str, nn.Module]:
    """The synthesis path's models: the text encoder, style encoder,
    pitch-energy predictor and speech predictor (the duration predictor
    does not change the audio where durations are fixed)."""
    models = build_models(mc)
    del models["duration_predictor"]
    return models


def slm(mc: ModelConfig) -> nn.Module:
    net = SLMFeatureExtractor(n_layers=mc.slm.layers)
    net.requires_grad_(False)
    return net.eval()


def loaded(models: Dict[str, nn.Module], weights: Dict[str, Dict],
           device) -> Dict[str, nn.Module]:
    """``models`` with ``weights`` (by model, then name) on ``device``."""
    out = {}
    for key, module in models.items():
        module = module.to_empty(device=device)
        module.load_state_dict(weights[key])
        out[key] = module
    return out


def train_state(models: Dict[str, nn.Module]) -> TrainState:
    device = next(iter(models.values())).parameters().__next__().device
    return TrainState(
        models=models,
        optimizers={k: make_optimizer(m) for k, m in models.items()},
        disc_ema={"mrd": torch.tensor(DISC_EMA_INIT, device=device)},
        step=0)


def frame_bucket(frames: int) -> int:
    return max(60, -(-frames // 20) * 20)


def text_bucket(n_tokens: int) -> int:
    return min(max(64, -(-n_tokens // 64) * 64), 512)


@torch.no_grad()
def speech_pcm(mc: ModelConfig, models: Dict[str, nn.Module],
               token_ids, per_token: int, generator: torch.Generator,
               device) -> np.ndarray:
    """int16 PCM [B, frames * hop] of one batch as the synthesis path
    computes it: each utterance's token ids bracketed by pads and padded
    to one text bucket, ``per_token`` frames a token, the frames rounded
    up to the 20-frame grid; the latent and the prior's noise drawn from
    ``generator``."""
    encoded = [[0] + list(ids) + [0] for ids in token_ids]
    bucket = text_bucket(max(len(ids) for ids in encoded))
    tokens = np.zeros((len(encoded), bucket), np.int64)
    durs = np.zeros((len(encoded), bucket), np.int64)
    frames = 60
    for i, ids in enumerate(encoded):
        tokens[i, :len(ids)] = ids
        durs[i, :len(ids)] = per_token
        frames = max(frames, frame_bucket(per_token * len(ids)))
    tokens = torch.from_numpy(tokens).to(device)
    lengths = torch.tensor([len(ids) for ids in encoded], device=device)
    durations = torch.from_numpy(durs).to(device)
    processor = DurationProcessor(mc.duration_predictor.duration_classes,
                                  mc.duration_predictor.max_duration)
    pe_enc, _, _ = models["pe_text_encoder"](tokens, lengths)
    style = models["pe_text_style_encoder"](pe_enc, lengths)
    alignment = processor.batched_duration_to_alignment(durations, frames)
    pitch, energy = models["pitch_energy_predictor"](
        pe_enc, lengths, alignment, style)
    pred = models["speech_predictor"](tokens, lengths, alignment, pitch,
                                      energy, generator=generator)
    audio = pred.audio.float()
    return torch.clamp(audio * 32767.0, -32768.0, 32767.0).to(
        torch.int16).cpu().numpy()
