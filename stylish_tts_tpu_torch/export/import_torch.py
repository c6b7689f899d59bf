"""Import a torch reference (stylish-tts) checkpoint.

The reference trains with HF Accelerate and checkpoints through
``accelerator.save_state`` (train/train.py:433-449): one
``pytorch_model[_N].bin`` (or ``model[_N].safetensors``) a prepared
model, numbered in the registration order of build_model
(train/models/models.py:79-101).  This module converts those weights
through ``models/torch_convert.py`` into:

* an inference artifact that ``speak`` and ``export/infer.py:Synthesizer``
  read (the layout of ``export/package.py``), the same files, tensor for
  tensor, that the JAX package's ``import-torch`` writes; or
* one module's flat safetensors (e.g. the aligner that the reference's
  ``save_alignment`` exports, train/train.py:425-430).

Conversion runs on the host in numpy; ``.bin`` files are unpickled by
``torch.load`` with ``weights_only=True``.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig, dump_json
from ..convert import export_flax_params, load_flax_params
from ..models.torch_convert import convert_module, converter
from ..utils.tensorfile import read_safetensors, write_safetensors

#: accelerator.save_state file index -> model name (reference
#: train/train.py:190-193 prepares build_model's Munch in insertion order)
REFERENCE_SAVE_ORDER = (
    "text_aligner",
    "duration_predictor",
    "pitch_energy_predictor",
    "speech_predictor",
    "mrd",
    "mpd",
    "pe_text_encoder",
    "pe_text_style_encoder",
    "pe_mel_style_encoder",
    "hubert_encoder",
    "cfm_mel_decoder",
    "cfm_pitch_predictor",
    "hubert_speech_predictor",
    "hubert_pitch_energy_predictor",
)

INFERENCE_MODELS = (
    "duration_predictor",
    "pe_text_encoder",
    "pe_text_style_encoder",
    "pitch_energy_predictor",
    "speech_predictor",
)

BATCH_STATS_PREFIX = "__batch_stats__/"

PathLike = Union[str, Path]


def _load_state_dict_file(path: PathLike) -> Dict[str, np.ndarray]:
    """One module's torch ``state_dict`` from a ``.safetensors`` file or a
    torch pickle (``.bin``, ``.pt``), as numpy arrays."""
    path = Path(path)
    if path.suffix == ".safetensors":
        return read_safetensors(path)
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    return {k: v.numpy() for k, v in sd.items()}


def _model_file(ckpt_dir: Path, index: int) -> Optional[Path]:
    """The file of save index ``index`` in a ``save_state`` directory, or
    None: ``pytorch_model[_N].bin`` before ``model[_N].safetensors``."""
    suffix = "" if index == 0 else f"_{index}"
    for name in (f"pytorch_model{suffix}.bin", f"model{suffix}.safetensors"):
        p = ckpt_dir / name
        if p.exists():
            return p
    return None


def load_reference_state_dicts(checkpoint_dir: PathLike
                               ) -> Dict[str, Dict[str, np.ndarray]]:
    """model name -> torch ``state_dict`` of every model file in an
    accelerator checkpoint directory."""
    ckpt = Path(checkpoint_dir)
    out = {}
    for i, name in enumerate(REFERENCE_SAVE_ORDER):
        p = _model_file(ckpt, i)
        if p is not None:
            out[name] = _load_state_dict_file(p)
    if not out:
        raise FileNotFoundError(
            f"no pytorch_model*.bin / model*.safetensors under {ckpt}")
    return out


def save_converted_module(out_path: PathLike, name: str, state_dict) -> None:
    """One module -> flat safetensors; its batch stats (the aligner's batch
    norms, the mel style encoder's spectral norms) share the file under
    ``BATCH_STATS_PREFIX``, at least 1-d as the JAX package writes them."""
    params, stats = convert_module(name, state_dict)
    flat = dict(params)
    for k, v in stats.items():
        flat[BATCH_STATS_PREFIX + k] = np.atleast_1d(np.asarray(v))
    write_safetensors(out_path, flat)


def load_converted_module(path: PathLike, name: str, module: nn.Module
                          ) -> nn.Module:
    """Fill ``module`` (model ``name``) from a ``save_converted_module``
    file, in place: the batch stats return to the module's own shapes (a
    scalar ``sigma``); a name left unused or a tensor left unfilled
    raises.  Returns the module."""
    flat = read_safetensors(path)
    shapes = {k: v.shape for k, v in export_flax_params(name, module).items()}
    merged = {}
    for key, value in flat.items():
        if key.startswith(BATCH_STATS_PREFIX):
            key = key[len(BATCH_STATS_PREFIX):]
            value = value.reshape(shapes.get(key, value.shape))
        merged[key] = value
    module.load_state_dict(load_flax_params(name, merged, module))
    return module


def import_torch_checkpoint(checkpoint: PathLike, out_dir: PathLike,
                            model_config: ModelConfig, *,
                            single_model: Optional[str] = None) -> Path:
    """Convert a reference checkpoint into an inference artifact at
    ``out_dir``.

    ``checkpoint`` is an accelerator ``save_state`` directory, or with
    ``single_model`` one state-dict file, written as
    ``out_dir/<single_model>.safetensors``.  The artifact's
    ``model_config.json`` sets ``pitch_energy_predictor.reference_band_mask``
    (a copy of ``model_config``): the reference trained under its inverted
    cross-attention band mask, and inference keeps it."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if single_model is not None:
        converter(single_model)
        save_converted_module(out / f"{single_model}.safetensors",
                              single_model, _load_state_dict_file(checkpoint))
        return out

    state_dicts = load_reference_state_dicts(checkpoint)
    missing = [m for m in INFERENCE_MODELS if m not in state_dicts]
    if missing:
        raise FileNotFoundError(
            f"checkpoint lacks model files for {missing} "
            f"(found {sorted(state_dicts)})")
    for name in INFERENCE_MODELS:
        save_converted_module(out / f"{name}.safetensors", name,
                              state_dicts[name])
    # the aligner rides along when present: ``align`` can reuse it
    if "text_aligner" in state_dicts:
        save_converted_module(out / "text_aligner.safetensors",
                              "text_aligner", state_dicts["text_aligner"])
    mc = copy.deepcopy(model_config)
    mc.pitch_energy_predictor.reference_band_mask = True
    (out / "model_config.json").write_text(dump_json(mc))
    (out / "metadata.json").write_text(json.dumps({
        "normalization": {}, "manifest": {},
        "source": "torch-reference-import"}))
    return out
