"""Load an inference artifact: ``model_config.json`` plus one
``<model>.safetensors`` of flat flax names for each inference model.

The safetensors format is read by hand (the card's machine has no
``safetensors`` package): an 8-byte little-endian header length, a JSON
header mapping each name to its dtype, shape and byte range, then the raw
little-endian data.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig, load_model_config_json
from ..convert import load_flax_params
from ..device import resolve_device
from ..models import INFERENCE_MODELS, build_models

_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}


def read_safetensors(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    """name -> numpy array for every tensor of a ``.safetensors`` file."""
    data = Path(path).read_bytes()
    if len(data) < 8:
        raise ValueError(f"{path}: not a safetensors file")
    (header_len,) = struct.unpack("<Q", data[:8])
    if 8 + header_len > len(data):
        raise ValueError(f"{path}: header runs past the end of the file")
    header = json.loads(data[8 : 8 + header_len].decode("utf-8"))
    body = memoryview(data)[8 + header_len :]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: {name} has unsupported dtype "
                             f"{info['dtype']}")
        dtype = np.dtype(_DTYPES[info["dtype"]]).newbyteorder("<")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * dtype.itemsize or end > len(body):
            raise ValueError(f"{path}: {name} has a bad byte range")
        out[name] = np.frombuffer(body[begin:end], dtype=dtype) \
            .reshape(shape).astype(dtype.newbyteorder("="))
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
