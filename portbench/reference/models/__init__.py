"""The inference models of the synthesis path, by their artifact names."""

from __future__ import annotations

from typing import Dict

from torch import nn

from ..config import ModelConfig
from .duration_predictor import DurationPredictor, text_encoder_for
from .pitch_energy_predictor import PitchEnergyPredictor
from .speech_predictor import SpeechPredictor
from .style_encoders import TextStyleEncoder

INFERENCE_MODELS = (
    "duration_predictor",
    "pe_text_encoder",
    "pe_text_style_encoder",
    "pitch_energy_predictor",
    "speech_predictor",
)


def build_models(mc: ModelConfig) -> Dict[str, nn.Module]:
    """The five models ``export/infer.py:Synthesizer`` runs, in eval mode
    (dropout off)."""
    pe_dim = mc.pitch_energy_predictor.inter_dim
    models = {
        "duration_predictor": DurationPredictor(mc),
        # the pitch/energy branch runs at its own width
        "pe_text_encoder": text_encoder_for(mc, pe_dim),
        "pe_text_style_encoder": TextStyleEncoder(
            pe_dim, mc.style_dim, mc.style_encoder.layers),
        "pitch_energy_predictor": PitchEnergyPredictor(mc),
        "speech_predictor": SpeechPredictor(mc),
    }
    return {k: m.eval() for k, m in models.items()}
