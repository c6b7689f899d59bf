"""The inference artifact: ``model_config.json``, ``metadata.json``
(normalisation stats and the run's manifest) and one
``<model>.safetensors`` of flat flax names for each inference model, the
layout the JAX package writes and reads.

``package_inference_artifact`` writes it from a training checkpoint;
``load_inference_models`` reads it.  The speech predictor's file keeps the
training-only posterior encoder, as the JAX package's does: its reader
needs it, and the port's skips it.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..config import ModelConfig, dump_json, load_model_config_json
from ..convert import load_flax_params
from ..device import resolve_device
from ..models import INFERENCE_MODELS, build_models
from ..train.init import build_training_models
# read_safetensors is also read from here by the artifact's callers
from ..utils.tensorfile import read_safetensors


def package_inference_artifact(checkpoint_dir: Union[str, Path],
                               out_path: Union[str, Path]) -> Path:
    """Write the artifact of the training checkpoint at
    ``checkpoint_dir`` (``train/checkpoint.py``) to ``out_path``.  Each
    inference model's file is checked against the model it fills (every
    name used, every parameter filled, every shape fitting), then copied."""
    ckpt = Path(checkpoint_dir)
    meta = json.loads((ckpt / "meta.json").read_text())
    mc = load_model_config_json(json.dumps(meta["model_config"]))
    models = build_training_models(mc)
    out = Path(out_path)
    out.mkdir(parents=True, exist_ok=True)
    for key in INFERENCE_MODELS:
        src = ckpt / "models" / f"{key}.safetensors"
        if not src.is_file():
            raise FileNotFoundError(f"{ckpt}: the checkpoint holds no {key}")
        load_flax_params(key, read_safetensors(src), models[key])
        shutil.copyfile(src, out / f"{key}.safetensors")
    (out / "model_config.json").write_text(dump_json(mc))
    (out / "metadata.json").write_text(json.dumps({
        "normalization": meta["normalization"],
        "manifest": meta["manifest"]}))
    return out


def load_inference_models(
    artifact_dir: Union[str, Path],
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[ModelConfig, Dict[str, nn.Module]]:
    """Build the five inference models and fill them from the artifact."""
    device = resolve_device(device)
    root = Path(artifact_dir)
    mc = load_model_config_json((root / "model_config.json").read_text())
    models = build_models(mc)
    for key in INFERENCE_MODELS:
        flat = read_safetensors(root / f"{key}.safetensors")
        models[key].load_state_dict(load_flax_params(key, flat, models[key]))
        models[key].to(device).eval()
    return mc, models
