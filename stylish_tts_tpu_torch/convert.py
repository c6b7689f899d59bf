"""Carry the JAX package's flax weights into the port.

The port's submodules are named after the flax tree, so a flat flax name
``a/b/kernel`` maps to the torch name ``a.b.weight`` and only the layout
changes:

* Dense ``kernel [in, out]`` -> ``Linear.weight [out, in]``
* DenseGeneral ``kernel [in, h, d]`` -> ``Linear.weight [h*d, in]``, and
  ``[h, d, out]`` (the SLM's ``out_proj``, which contracts two axes) ->
  ``[out, h*d]``; a bias ``[h, d]`` -> ``[h*d]``
* Conv ``kernel [k, in/g, out]`` -> ``weight [out, in/g, k]`` and
  ``[kh, kw, in/g, out]`` -> ``[out, in/g, kh, kw]``
* Embed ``embedding`` and LayerNorm/GroupNorm ``scale`` -> ``weight``
* WeightNorm ``WeightNorm_k/<conv>/kernel/scale`` -> ``<conv>.scale``
* SpectralNorm batch stats ``SpectralNorm_0/<conv>/kernel/{u,sigma}`` ->
  the buffers ``u`` and ``sigma`` of the spectral-norm module
* every other leaf (``bias``, ``gamma``, ``beta``, the SLM's own params) as
  it is, under its own name

Batch stats are passed in the same flat dict as the params.
``export_flax_params`` is the inverse: a module's ``state_dict`` back to
the flat flax names and shapes, the head count of a DenseGeneral and the
index of a WeightNorm scope read from the module itself.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
from torch import nn

from .models.discriminator import WNConv2d
from .models.style_encoders import SpectralConv

# training-only subtrees an inference artifact carries that the port's
# inference models do not hold (the posterior encoder runs only on
# ground-truth audio); they are skipped for a module that has no such
# parameters
TRAINING_ONLY = {"speech_predictor": ("posterior_encoder/",)}
# DenseGeneral kernels that contract two input axes ([h, d, out]) and
# those that split their output into heads ([in, h, d], bias [h, d]); both
# sit in an attention module that holds ``n_heads``
_TWO_AXIS_DENSE = ("out_proj",)
_HEAD_SPLIT_DENSE = ("q_proj", "k_proj", "v_proj")

_LEAF_NAMES = {"kernel": "weight", "embedding": "weight", "scale": "weight"}


def _torch_key(path: List[str], leaf: str) -> str:
    if len(path) >= 3 and path[-1] == "kernel":
        if leaf == "scale" and path[-3].startswith("WeightNorm_"):
            return ".".join(path[:-3] + [path[-2], "scale"])
        if leaf in ("u", "sigma") and path[-3].startswith("SpectralNorm_"):
            return ".".join(path[:-3] + [leaf])
    return ".".join(path + [_LEAF_NAMES.get(leaf, leaf)])


def _convert(path: List[str], leaf: str, value: np.ndarray,
             target: Sequence[int]) -> np.ndarray:
    if leaf == "kernel":
        if value.ndim == 2:
            return value.T
        if value.ndim == 3 and len(target) == 2:  # DenseGeneral
            lead = 2 if path[-1] in _TWO_AXIS_DENSE else 1
            return value.reshape(int(np.prod(value.shape[:lead])), -1).T
        if value.ndim == 3:
            return value.transpose(2, 1, 0)
        if value.ndim == 4:
            return value.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel of rank {value.ndim} has no mapping")
    if leaf == "bias" and value.ndim == 2 and len(target) == 1:
        return value.reshape(-1)  # DenseGeneral bias [h, d]
    return value


def load_flax_params(model_name: str, flat: Dict[str, np.ndarray],
                     module: nn.Module) -> Dict[str, torch.Tensor]:
    """Flat flax params (and batch stats) of ``model_name`` -> a
    ``state_dict`` for ``module``.

    Raises on any flax key left unused (apart from the model's
    ``TRAINING_ONLY`` subtrees when ``module`` does not hold them), on any
    parameter or buffer of ``module`` left unfilled, and on any shape that
    does not match."""
    expected = module.state_dict()
    skip = tuple(
        prefix for prefix in TRAINING_ONLY.get(model_name, ())
        if not any(k.startswith(prefix.replace("/", ".")) for k in expected))
    state: Dict[str, torch.Tensor] = {}
    unused = []
    for name, value in flat.items():
        if skip and name.startswith(skip):
            continue
        *path, leaf = name.split("/")
        key = _torch_key(path, leaf)
        if key not in expected:
            unused.append(name)
            continue
        # np.array, not ascontiguousarray: that makes a 0-d sigma 1-d
        array = np.array(_convert(path, leaf, np.asarray(value),
                                  expected[key].shape), order="C")
        if tuple(array.shape) != tuple(expected[key].shape):
            raise ValueError(
                f"{model_name}: {name} {array.shape} does not fit {key} "
                f"{tuple(expected[key].shape)}")
        state[key] = torch.tensor(array, dtype=torch.float32)
    if unused:
        raise KeyError(f"{model_name}: flax keys left unused: {unused}")
    unfilled = sorted(set(expected) - set(state))
    if unfilled:
        raise KeyError(f"{model_name}: port parameters left unfilled: "
                       f"{unfilled}")
    return state


def _heads(parent: nn.Module, name: str, names: Sequence[str]) -> int:
    """The head count of DenseGeneral ``name`` in ``parent``, or 0 when it
    is a plain Dense."""
    return getattr(parent, "n_heads", 0) if name in names else 0


def _flax_entry(module: nn.Module, name: str, value: np.ndarray):
    """(flat flax name, array in flax layout) of one ``state_dict`` entry
    of ``module``: the inverse of ``_torch_key`` and ``_convert``."""
    *path, leaf = name.split(".")
    owner = module.get_submodule(".".join(path))
    parent = module.get_submodule(".".join(path[:-1])) if path else None
    if isinstance(owner, SpectralConv) and leaf in ("u", "sigma"):
        return "/".join(path + ["SpectralNorm_0", "Conv_0", "kernel",
                                leaf]), value
    if isinstance(owner, WNConv2d) and leaf == "scale":
        convs = [m for m in parent.children() if isinstance(m, WNConv2d)]
        index = next(i for i, m in enumerate(convs) if m is owner)
        return "/".join(path[:-1] + [f"WeightNorm_{index}", path[-1],
                                     "kernel", "scale"]), value
    head = path[-1] if path else ""
    if leaf == "weight" and isinstance(owner, nn.Embedding):
        return "/".join(path + ["embedding"]), value
    if leaf == "weight" and value.ndim == 1:  # LayerNorm / GroupNorm
        return "/".join(path + ["scale"]), value
    if leaf == "weight":
        if value.ndim == 2:
            split = _heads(parent, head, _HEAD_SPLIT_DENSE)
            contract = _heads(parent, head, _TWO_AXIS_DENSE)
            if split:  # [h*d, in] -> [in, h, d]
                value = value.T.reshape(value.shape[1], split, -1)
            elif contract:  # [out, h*d] -> [h, d, out]
                value = value.T.reshape(contract, -1, value.shape[0])
            else:
                value = value.T
        elif value.ndim == 3:
            value = value.transpose(2, 1, 0)
        elif value.ndim == 4:
            value = value.transpose(2, 3, 1, 0)
        else:
            raise ValueError(f"weight of rank {value.ndim} has no mapping")
        return "/".join(path + ["kernel"]), value
    h = _heads(parent, head, _HEAD_SPLIT_DENSE)
    if leaf == "bias" and h:
        value = value.reshape(h, -1)
    return "/".join(path + [leaf]), value


def export_flax_params(model_name: str, module: nn.Module
                       ) -> Dict[str, np.ndarray]:
    """``module``'s parameters and buffers -> flat flax params (and batch
    stats) of ``model_name``: the names and shapes of the JAX package's
    variables, so that ``load_flax_params`` of the result gives the
    ``state_dict`` back exactly."""
    flat: Dict[str, np.ndarray] = {}
    for name, tensor in module.state_dict().items():
        key, value = _flax_entry(module, name,
                                 tensor.detach().cpu().numpy())
        if key in flat:
            raise ValueError(f"{model_name}: {name} and another tensor both "
                             f"map to {key}")
        flat[key] = np.array(value, order="C")
    return flat
