"""Model configuration: a stdlib-dataclass copy of the model schema.

Field names, defaults and nesting equal the JAX package's pydantic
``ModelConfig``, so the ``model_config.json`` that an inference artifact
carries (pydantic's ``model_dump_json``) loads here unchanged.  Only the
stdlib is used: the card's machine has no pydantic or yaml.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass, field
from typing import List, Optional, Union


@dataclass
class TextAlignerConfig:
    hidden_dim: int = 640
    token_embedding_dim: int = 512


@dataclass
class DecoderConfig:
    hidden_dim: int = 512
    residual_dim: int = 64


@dataclass
class FreeGANGeneratorConfig:
    """Harmonic-prior ConvNeXt vocoder head."""

    type: str = "freegan"
    input_dim: int = 512
    hidden_dim: int = 512
    conv_intermediate_dim: int = 1536
    io_conv_kernel_size: int = 7
    conformer_layers: int = 5
    conv_layers: int = 5


@dataclass
class RingformerGeneratorConfig:
    """Legacy HiFiGAN-style head; parsed so configs load, not yet ported."""

    type: str = "ringformer"
    resblock_kernel_sizes: List[int] = field(default_factory=lambda: [3, 7, 11])
    upsample_rates: List[int] = field(default_factory=lambda: [4, 5])
    upsample_initial_channel: int = 512
    upsample_last_channel: int = 128
    resblock_dilation_sizes: List[List[int]] = field(
        default_factory=lambda: [[1, 3, 5], [1, 3, 5], [1, 3, 5]]
    )
    upsample_kernel_sizes: List[int] = field(default_factory=lambda: [8, 10])
    gen_istft_n_fft: int = 60
    gen_istft_hop_size: int = 15
    depth: int = 2


GeneratorConfig = Union[FreeGANGeneratorConfig, RingformerGeneratorConfig]
_GENERATORS = {"freegan": FreeGANGeneratorConfig,
               "ringformer": RingformerGeneratorConfig}


@dataclass
class TextEncoderConfig:
    tokens: int = 178
    hidden_dim: int = 128
    filter_channels: int = 512
    heads: int = 8
    layers: int = 8
    kernel_size: int = 3
    dropout: float = 0.2


@dataclass
class StyleEncoderConfig:
    layers: int = 2


@dataclass
class MelStyleEncoderConfig:
    max_channels: int = 384
    skip_downsample: bool = True


@dataclass
class DurationPredictorConfig:
    n_layer: int = 4
    duration_classes: int = 16
    max_duration: int = 50
    dropout: float = 0.2
    last_dropout: float = 0.5


@dataclass
class PitchEnergyPredictorConfig:
    inter_dim: int = 256
    dropout: float = 0.2
    # True keeps the inverted cross-attention band mask that checkpoints
    # migrated from the torch reference were trained with
    reference_band_mask: bool = False


@dataclass
class HubertConfig:
    model: str = "dr87/spinv2_rvc"
    hidden_dim: int = 768
    sr: int = 16000
    weights_path: Optional[str] = None


@dataclass
class SpeakerEmbedderConfig:
    hidden_dim: int = 10240
    weights_path: Optional[str] = None


@dataclass
class SlmConfig:
    model: str = "microsoft/wavlm-base-plus"
    sr: int = 16000
    layers: int = 12
    weights_path: Optional[str] = None


@dataclass
class SymbolConfig:
    pad: str = "$"
    punctuation: str = ';:,.!?¡¿—…"()“” '
    letters: str = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
    # exact inventory of the reference, so token ids match its checkpoints
    letters_ipa: str = "ɑɐɒæɓʙβɔɕçɗɖðʤəɘɚɛɜɝɞɟʄɡɠɢʛɦɧħɥʜɨɪʝɭɬɫɮʟɱɯɰŋɳɲɴøɵɸθœɶʘɹɺɾɻʀʁɽʂʃʈʧʉʊʋⱱʌɣɤʍχʎʏʑʐʒʔʡʕʢǀǁᵊǃˈˌːˑʼʴʰʱʲʷˠˤ˞↓↑→↗↘'̩'ᵻ"


@dataclass
class ModelConfig:
    """Architecture config (reference ``train/config/model.yml``)."""

    multispeaker: bool = False
    n_mels: int = 80
    sample_rate: int = 24000
    n_fft: int = 2048
    win_length: int = 1200
    hop_length: int = 300
    style_dim: int = 64
    inter_dim: int = 128
    cfm_mel_features: str = "model"
    remat_flow: bool = False
    mrd_pallas: bool = False

    text_aligner: TextAlignerConfig = field(default_factory=TextAlignerConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    generator: GeneratorConfig = field(default_factory=FreeGANGeneratorConfig)
    text_encoder: TextEncoderConfig = field(default_factory=TextEncoderConfig)
    style_encoder: StyleEncoderConfig = field(default_factory=StyleEncoderConfig)
    mel_style_encoder: MelStyleEncoderConfig = field(
        default_factory=MelStyleEncoderConfig
    )
    duration_predictor: DurationPredictorConfig = field(
        default_factory=DurationPredictorConfig
    )
    pitch_energy_predictor: PitchEnergyPredictorConfig = field(
        default_factory=PitchEnergyPredictorConfig
    )
    hubert: HubertConfig = field(default_factory=HubertConfig)
    speaker_embedder: SpeakerEmbedderConfig = field(
        default_factory=SpeakerEmbedderConfig
    )
    slm: SlmConfig = field(default_factory=SlmConfig)
    symbol: SymbolConfig = field(default_factory=SymbolConfig)

    def state_dict(self) -> dict:
        return dataclasses.asdict(self)


def _build(cls, raw: dict):
    """Construct dataclass ``cls`` from a nested dict, rejecting unknown keys."""
    if not isinstance(raw, dict):
        raise TypeError(f"{cls.__name__} expects an object, got {raw!r}")
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(raw) - names
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown keys {sorted(unknown)}")
    kwargs = {}
    for key, value in raw.items():
        hint = hints[key]
        if hint == GeneratorConfig:
            kind = value.get("type", "freegan")
            if kind not in _GENERATORS:
                raise ValueError(f"unknown generator type {kind!r}")
            kwargs[key] = _build(_GENERATORS[kind], value)
        elif dataclasses.is_dataclass(hint):
            kwargs[key] = _build(hint, value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


def load_model_config_json(data: str) -> ModelConfig:
    """Parse the JSON written by ``model_dump_json`` of the model schema."""
    return _build(ModelConfig, json.loads(data))
