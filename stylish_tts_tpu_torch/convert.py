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
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
from torch import nn

# training-only subtrees an inference artifact carries that the port's
# inference models do not hold (the posterior encoder runs only on
# ground-truth audio); they are skipped for a module that has no such
# parameters
TRAINING_ONLY = {"speech_predictor": ("posterior_encoder/",)}
# DenseGeneral kernels that contract two input axes ([h, d, out])
_TWO_AXIS_DENSE = ("out_proj",)

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
