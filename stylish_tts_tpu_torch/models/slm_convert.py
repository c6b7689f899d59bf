"""Convert a torch WavLM (or HuBERT) checkpoint to the flat flax names of
the SLM feature extractor (``models/slm.py``): a copy of the JAX package's
``models/slm_convert.py``.

The reference consumes HF ``microsoft/wavlm-base-plus`` directly; here the
weights are converted once, offline, to a flat safetensors file keyed by
the flax param paths that ``slm.weights_path`` (and, for HuBERT,
``hubert.weights_path``) read.  The positional conv's weight norm is
folded into a plain kernel.

Nothing here imports ``transformers``: ``convert_wavlm_model`` and
``convert_hubert_model`` take any object with ``.config``,
``.state_dict()`` and ``.encoder.pos_conv_embed.conv.weight``; the
scripts ``scripts/convert_wavlm.py`` and ``scripts/convert_hubert.py``
read a local checkpoint directory through ``convert_wavlm_state_dict``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np


def convert_wavlm_state_dict(
    state_dict: Dict[str, "np.ndarray"],
    n_layers: int,
    n_heads: int,
    gated: bool = True,
) -> Dict[str, np.ndarray]:
    """torch WavLM/HuBERT/wav2vec2 model state_dict -> flat flax arrays.

    ``gated=True`` converts WavLM's gated relative-position-bias attention;
    ``gated=False`` converts the plain attention of HuBERT/wav2vec2-base
    (identical layout otherwise)."""

    sd = {
        k: np.asarray(getattr(v, "detach", lambda: v)().cpu().numpy()
                      if hasattr(v, "cpu") else v)
        for k, v in state_dict.items()
    }
    out: Dict[str, np.ndarray] = {}

    def put(name, arr):
        out[name] = np.ascontiguousarray(arr.astype(np.float32))

    for i in range(7):
        # torch conv1d (out, in, k) -> flax (k, in, out)
        put(
            f"conv_{i}/kernel",
            sd[f"feature_extractor.conv_layers.{i}.conv.weight"].transpose(2, 1, 0),
        )
    put("gn/scale", sd["feature_extractor.conv_layers.0.layer_norm.weight"])
    put("gn/bias", sd["feature_extractor.conv_layers.0.layer_norm.bias"])

    put("fp_ln/scale", sd["feature_projection.layer_norm.weight"])
    put("fp_ln/bias", sd["feature_projection.layer_norm.bias"])
    put("feature_proj/kernel", sd["feature_projection.projection.weight"].T)
    put("feature_proj/bias", sd["feature_projection.projection.bias"])

    # weight-normed positional conv: fold g * v / ||v|| (norm over out+in,
    # per kernel position — torch weight_norm dim=2 on (out, in/g, k))
    pfx = "encoder.pos_conv_embed.conv"
    if f"{pfx}.weight" in sd:
        w = sd[f"{pfx}.weight"]
    else:
        if f"{pfx}.parametrizations.weight.original0" in sd:
            g = sd[f"{pfx}.parametrizations.weight.original0"]
            v = sd[f"{pfx}.parametrizations.weight.original1"]
        else:
            g, v = sd[f"{pfx}.weight_g"], sd[f"{pfx}.weight_v"]
        w = g * v / np.linalg.norm(v, axis=(0, 1), keepdims=True)
    put("pos_conv/kernel", w.transpose(2, 1, 0))
    put("pos_conv/bias", sd[f"{pfx}.bias"])

    put("encoder_ln/scale", sd["encoder.layer_norm.weight"])
    put("encoder_ln/bias", sd["encoder.layer_norm.bias"])
    if gated:
        put(
            "rel_attn_embed",
            sd["encoder.layers.0.attention.rel_attn_embed.weight"],
        )

    dim = sd["feature_projection.projection.weight"].shape[0]
    head_dim = dim // n_heads
    for i in range(n_layers):
        lp = f"encoder.layers.{i}"
        a = f"layer_{i}_attn"
        for proj in ("q_proj", "k_proj", "v_proj"):
            # (out, in) -> (in, heads, head_dim)
            put(
                f"{a}/{proj}/kernel",
                sd[f"{lp}.attention.{proj}.weight"].T.reshape(
                    dim, n_heads, head_dim
                ),
            )
            put(
                f"{a}/{proj}/bias",
                sd[f"{lp}.attention.{proj}.bias"].reshape(n_heads, head_dim),
            )
        # out_proj input is head-major concat: (out, in) -> (h, d, out)
        put(
            f"{a}/out_proj/kernel",
            sd[f"{lp}.attention.out_proj.weight"].T.reshape(
                n_heads, head_dim, dim
            ),
        )
        put(f"{a}/out_proj/bias", sd[f"{lp}.attention.out_proj.bias"])
        if gated:
            put(
                f"{a}/gru_rel_pos_linear/kernel",
                sd[f"{lp}.attention.gru_rel_pos_linear.weight"].T,
            )
            put(
                f"{a}/gru_rel_pos_linear/bias",
                sd[f"{lp}.attention.gru_rel_pos_linear.bias"],
            )
            put(
                f"{a}/gru_rel_pos_const",
                sd[f"{lp}.attention.gru_rel_pos_const"].reshape(
                    1, 1, n_heads
                ),
            )
        put(f"layer_{i}_ln1/scale", sd[f"{lp}.layer_norm.weight"])
        put(f"layer_{i}_ln1/bias", sd[f"{lp}.layer_norm.bias"])
        put(f"layer_{i}_fc1/kernel", sd[f"{lp}.feed_forward.intermediate_dense.weight"].T)
        put(f"layer_{i}_fc1/bias", sd[f"{lp}.feed_forward.intermediate_dense.bias"])
        put(f"layer_{i}_fc2/kernel", sd[f"{lp}.feed_forward.output_dense.weight"].T)
        put(f"layer_{i}_fc2/bias", sd[f"{lp}.feed_forward.output_dense.bias"])
        put(f"layer_{i}_ln2/scale", sd[f"{lp}.final_layer_norm.weight"])
        put(f"layer_{i}_ln2/bias", sd[f"{lp}.final_layer_norm.bias"])
    return out


def convert_wavlm_model(model, n_layers: int | None = None) -> Dict[str, np.ndarray]:
    """Convert a live ``transformers.WavLMModel`` (weight norm resolved by
    reading the effective ``conv.weight`` property)."""
    return _convert_live(model, n_layers, gated=True)


def convert_hubert_model(
    model, n_layers: int | None = None
) -> Dict[str, np.ndarray]:
    """Convert a live ``transformers.HubertModel`` (or wav2vec2-base) for
    ``models/ssl.py:AdaptiveHubert``'s encoder (reference ssl.py:16-31)."""
    return _convert_live(model, n_layers, gated=False)


def _convert_live(model, n_layers, gated) -> Dict[str, np.ndarray]:
    cfg = model.config
    sd = dict(model.state_dict())
    # the parametrized property gives the folded weight directly
    sd["encoder.pos_conv_embed.conv.weight"] = (
        model.encoder.pos_conv_embed.conv.weight.detach()
    )
    return convert_wavlm_state_dict(
        sd,
        n_layers if n_layers is not None else cfg.num_hidden_layers,
        cfg.num_attention_heads,
        gated=gated,
    )


def read_checkpoint_directory(path) -> Tuple[dict, Dict[str, np.ndarray]]:
    """(config, state dict) of a local HF checkpoint directory:
    ``config.json`` and ``model.safetensors`` or ``pytorch_model.bin``.
    A hub name that is not a local directory raises: this package reads
    local files only (it imports neither ``transformers`` nor
    ``huggingface_hub``, and the card's machine has no network)."""
    from ..export.import_torch import load_state_dict_file

    root = Path(path)
    if not root.is_dir():
        raise FileNotFoundError(
            f"{path!r} is not a local checkpoint directory; a hub name needs "
            f"a download, which this package does not do: download the "
            f"checkpoint elsewhere and pass its directory")
    config = json.loads((root / "config.json").read_text())
    for name in ("model.safetensors", "pytorch_model.bin"):
        if (root / name).is_file():
            return config, load_state_dict_file(root / name)
    raise FileNotFoundError(f"{root}: no model.safetensors or "
                            f"pytorch_model.bin")


def convert_checkpoint_directory(path, gated: bool,
                                 n_layers: Optional[int] = None
                                 ) -> Dict[str, np.ndarray]:
    """A local WavLM (``gated``) or HuBERT checkpoint directory -> flat
    flax arrays, through ``convert_wavlm_state_dict``: the positional
    conv's weight norm folded from the state dict's g and v."""
    config, sd = read_checkpoint_directory(path)
    return convert_wavlm_state_dict(
        sd, n_layers if n_layers is not None else config["num_hidden_layers"],
        config["num_attention_heads"], gated=gated)
