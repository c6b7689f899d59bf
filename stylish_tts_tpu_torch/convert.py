"""Carry the JAX package's flax weights into the port.

The port's submodules are named after the flax tree, so a flat flax name
``a/b/kernel`` maps to the torch name ``a.b.weight`` and only the layout
changes:

* Dense ``kernel [in, out]`` -> ``Linear.weight [out, in]``
* Conv ``kernel [k, in/g, out]`` -> ``weight [out, in/g, k]``
* Embed ``embedding`` and LayerNorm ``scale`` -> ``weight`` as they are
* ``bias`` and the custom ``gamma``/``beta`` parameters as they are
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

# training-only subtrees an inference artifact carries that the port's
# inference models do not hold (the posterior encoder runs only on
# ground-truth audio)
TRAINING_ONLY = {"speech_predictor": ("posterior_encoder/",)}

_LEAF_NAMES = {"kernel": "weight", "embedding": "weight", "scale": "weight",
               "bias": "bias", "gamma": "gamma", "beta": "beta"}


def _convert_leaf(leaf: str, value: np.ndarray) -> np.ndarray:
    if leaf == "kernel":
        if value.ndim == 2:
            return value.T
        if value.ndim == 3:
            return value.transpose(2, 1, 0)
        raise ValueError(f"kernel of rank {value.ndim} has no mapping")
    return value


def load_flax_params(model_name: str, flat: Dict[str, np.ndarray],
                     module: nn.Module) -> Dict[str, torch.Tensor]:
    """Flat flax params of ``model_name`` -> a ``state_dict`` for ``module``.

    Raises on any flax key left unused (apart from the model's
    ``TRAINING_ONLY`` subtrees), on any parameter of ``module`` left
    unfilled, and on any shape that does not match."""
    expected = module.state_dict()
    skip = TRAINING_ONLY.get(model_name, ())
    state: Dict[str, torch.Tensor] = {}
    unused = []
    for name, value in flat.items():
        if name.startswith(skip):
            continue
        *path, leaf = name.split("/")
        if leaf not in _LEAF_NAMES:
            unused.append(name)
            continue
        key = ".".join(path + [_LEAF_NAMES[leaf]])
        if key not in expected:
            unused.append(name)
            continue
        array = np.ascontiguousarray(_convert_leaf(leaf, np.asarray(value)))
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
