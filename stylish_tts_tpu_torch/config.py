"""Model and run configuration: stdlib-dataclass copies of the schemas.

Field names, defaults and nesting equal the JAX package's pydantic
``ModelConfig`` and ``Config``, so the JSON that pydantic's
``model_dump_json`` writes (an inference artifact's ``model_config.json``, a
run's config) loads here unchanged, and ``dump_json`` writes that JSON
back.  Only the stdlib is used: the card's machine has no pydantic and
is not known to have PyYAML, so ``load_config_file`` reads YAML only where
``yaml`` imports.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass, field
from pathlib import Path
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
    """Legacy HiFiGAN-style head (`models/ringformer.py`)."""

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


# --------------------------------------------------------------------------- #
# run config: training plan, dataset, validation, loss weights


@dataclass
class StagePlanConfig:
    epochs: int = 20
    probe_batch_max: int = 32
    lr: float = 1e-4


def _plan(epochs: int):
    return field(default_factory=lambda: StagePlanConfig(epochs=epochs))


@dataclass
class TrainingPlanConfig:
    alignment: StagePlanConfig = _plan(20)
    acoustic: StagePlanConfig = _plan(20)
    textual: StagePlanConfig = _plan(20)
    style: StagePlanConfig = _plan(10)
    duration: StagePlanConfig = _plan(10)
    joint: StagePlanConfig = _plan(10)
    hubert_acoustic: StagePlanConfig = _plan(20)
    cfm_hubert_mel: StagePlanConfig = _plan(20)
    cfm_hubert_pitch: StagePlanConfig = _plan(20)


@dataclass
class TrainingConfig:
    log_interval: int = 100
    save_interval: int = 2000
    val_interval: int = 2000
    device: str = "tpu"
    # "bf16": module forwards in bf16 on f32 master weights; "no": all f32
    mixed_precision: str = "bf16"
    vocos_weights: Optional[str] = None
    memory_budget_mib: int = 14000
    aot_memory_plan: bool = True


@dataclass
class DatasetConfig:
    train_data: str = "train-list.txt"
    val_data: str = "val-list.txt"
    wav_path: str = "wav24"
    path: str = "."
    pitch_path: str = "pitch.safetensors"
    alignment_path: str = "alignment.safetensors"
    alignment_model_path: str = "alignment_model.safetensors"


@dataclass
class ValidationConfig:
    sample_count: int = 6
    force_samples: List[str] = field(default_factory=list)


@dataclass
class LossWeightConfig:
    """Per-loss weights of the weighted totals."""

    mel: float = 1.0
    generator: float = 1.0
    slm: float = 1.0
    pitch: float = 1.0
    energy: float = 1.0
    mag: float = 1.0
    phase: float = 1.0
    style: float = 1.0
    duration: float = 1.0
    duration_ce: float = 1.0
    confidence: float = 1.0
    align_loss: float = 1.0
    discriminator: float = 1.0
    kl_text: float = 1.0
    kl_audio: float = 1.0


@dataclass
class MeshConfig:
    data_axis: str = "data"
    model_axis: str = "model"
    model_parallel_size: int = 1


@dataclass
class Config:
    training: TrainingConfig = field(default_factory=TrainingConfig)
    training_plan: TrainingPlanConfig = field(
        default_factory=TrainingPlanConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    validation: ValidationConfig = field(default_factory=ValidationConfig)
    loss_weight: LossWeightConfig = field(default_factory=LossWeightConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

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


def load_config_json(data: str) -> Config:
    """Parse the JSON written by ``model_dump_json`` of the run schema."""
    return _build(Config, json.loads(data))


def load_config_file(path: Union[str, Path], cls=Config):
    """A ``Config`` (or ``cls``) from a JSON file, or from a YAML file
    where PyYAML imports; raises naming the JSON form where it does not."""
    path = Path(path)
    text = path.read_text(encoding="utf-8")
    if path.suffix.lower() in (".yml", ".yaml"):
        try:
            import yaml
        except ImportError:
            raise RuntimeError(
                f"{path}: reading YAML needs PyYAML, which is not "
                f"installed; write the config as JSON (the same keys, as "
                f"dump_json writes them) and pass the .json file") from None
        return _build(cls, yaml.safe_load(text) or {})
    return _build(cls, json.loads(text))


def dump_json(config: Union[ModelConfig, Config]) -> str:
    """The JSON that pydantic's ``model_dump_json`` writes for the same
    config in the JAX package: fields in order, compact, not ASCII-escaped."""
    return json.dumps(dataclasses.asdict(config), ensure_ascii=False,
                      separators=(",", ":"))
