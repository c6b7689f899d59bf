"""Checkpoint and resume of a training run (reference:
accelerator.save_state, train/train.py:433-449; directories named
``checkpoint_{epoch:05d}_step_{total:09d}``).

A checkpoint is a directory of safetensors files and one JSON file:

* ``models/<model>.safetensors``: every parameter and buffer of the model
  under the flat names and in the shapes of the JAX package's flax
  variables (``convert.export_flax_params``), so packaging an inference
  artifact is a check and a copy;
* ``optim/<model>.safetensors``: the model's AdamW state by parameter
  name, ``<name>/exp_avg``, ``<name>/exp_avg_sq`` and ``<name>/step``;
* ``priors.safetensors``: the CTC label priors and their epoch
  accumulators (``TrainState.priors``);
* ``meta.json``: the manifest, the normalisation stats, the run and model
  configs, the train state's step and discriminator EMA, each optimizer's
  hyper-parameters and the run's ``torch.Generator`` state.

``load_checkpoint`` fills a train state built for the same models in place
and raises on a missing or unused tensor.  The JAX package also migrates
orbax checkpoints that keep Adam moments as one flat vector per module
(its ``_restore_legacy_flat``); no checkpoint of the port has that layout,
so that migration is not ported.
"""

from __future__ import annotations

import json
import shutil
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..convert import export_flax_params, load_flax_params
from ..utils.tensorfile import read_safetensors, write_safetensors
from .state import TrainState


@dataclass
class Manifest:
    current_epoch: int = 0
    current_step: int = 0
    steps_per_epoch: int = 0
    current_total_step: int = 0
    total_trained_audio_seconds: float = 0.0
    stage: str = "first"
    best_loss: float = float("inf")

    def state_dict(self) -> dict:
        return asdict(self)

    def load_state_dict(self, state: dict) -> None:
        for key, value in state.items():
            if hasattr(self, key):
                setattr(self, key, value)


@dataclass
class NormalizationStats:
    mel_log_mean: float = -4.0
    mel_log_std: float = 4.0
    frames: int = 0
    f0_log2_mean: float = 7.0
    f0_log2_std: float = 1.0


def checkpoint_name(epoch: int, total_step: int) -> str:
    return f"checkpoint_{epoch:05d}_step_{total_step:09d}"


def save_model_safetensors(path: Union[str, Path], model_name: str,
                           module: nn.Module) -> None:
    """One model's parameters and buffers under flat flax names."""
    write_safetensors(path, export_flax_params(model_name, module))


def load_model_safetensors(path: Union[str, Path], model_name: str,
                           module: nn.Module) -> nn.Module:
    """Fill ``module`` in place from a file of flat flax names; raises on
    a tensor left unused or a parameter left unfilled."""
    module.load_state_dict(load_flax_params(
        model_name, read_safetensors(path), module))
    return module


def _optimizer_tensors(module: nn.Module,
                       optimizer: torch.optim.Optimizer
                       ) -> Dict[str, np.ndarray]:
    names = {id(p): n for n, p in module.named_parameters()}
    flat = {}
    for group in optimizer.param_groups:
        for p in group["params"]:
            for key, value in optimizer.state.get(p, {}).items():
                flat[f"{names[id(p)]}/{key}"] = value.detach().cpu().numpy()
    return flat


def _hyper_parameters(optimizer: torch.optim.Optimizer) -> list:
    return [{k: v for k, v in group.items() if k != "params"}
            for group in optimizer.param_groups]


def _load_optimizer(model_name: str, module: nn.Module,
                    optimizer: torch.optim.Optimizer,
                    flat: Dict[str, np.ndarray], groups: list) -> None:
    names = {id(p): n for n, p in module.named_parameters()}
    left: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, value in flat.items():
        name, _, leaf = key.rpartition("/")
        left.setdefault(name, {})[leaf] = torch.from_numpy(value)
    state, group_indices, bare, index = {}, [], [], 0
    for group in optimizer.param_groups:
        indices = []
        for p in group["params"]:
            entry = left.pop(names[id(p)], None)
            if entry:
                state[index] = entry
            else:
                bare.append(names[id(p)])
            indices.append(index)
            index += 1
        group_indices.append(indices)
    if left:
        raise KeyError(f"{model_name}: optimizer tensors left unused: "
                       f"{sorted(f'{n}/{k}' for n in left for k in left[n])}")
    kinds = {tuple(sorted(entry)) for entry in state.values()}
    if state and (bare or len(kinds) != 1):
        raise KeyError(f"{model_name}: optimizer state missing for "
                       f"{bare or 'part of some parameters'}")
    if len(groups) != len(group_indices):
        raise ValueError(f"{model_name}: {len(groups)} saved param groups, "
                         f"the optimizer has {len(group_indices)}")
    # JSON gave the betas back as a list
    optimizer.load_state_dict({"state": state, "param_groups": [
        {**{k: tuple(v) if isinstance(v, list) else v
            for k, v in saved.items()}, "params": indices}
        for saved, indices in zip(groups, group_indices)]})


def save_checkpoint(
    out_dir: Union[str, Path],
    name: str,
    state: TrainState,
    manifest: Manifest,
    normalization: NormalizationStats,
    config_json: str,
    model_config_json: str,
    generator: Optional[torch.Generator] = None,
) -> Path:
    """Write ``state`` and the run's bookkeeping to ``out_dir/name``,
    replacing a checkpoint of that name; ``generator`` is the run's
    ``torch.Generator``, whose state resume restores."""
    path = Path(out_dir) / name
    tmp = path.with_name(path.name + ".partial")
    if tmp.exists():
        shutil.rmtree(tmp)
    (tmp / "models").mkdir(parents=True)
    (tmp / "optim").mkdir()
    for key, module in state.models.items():
        save_model_safetensors(tmp / "models" / f"{key}.safetensors", key,
                               module)
        write_safetensors(tmp / "optim" / f"{key}.safetensors",
                          _optimizer_tensors(module, state.optimizers[key]))
    write_safetensors(tmp / "priors.safetensors",
                      {k: v.detach().cpu().numpy()
                       for k, v in state.priors.items()})
    meta = {
        "manifest": manifest.state_dict(),
        "normalization": asdict(normalization),
        "config": json.loads(config_json),
        "model_config": json.loads(model_config_json),
        "train_state": {
            "step": state.step,
            "disc_ema": {k: float(v) for k, v in state.disc_ema.items()},
            "optimizers": {k: _hyper_parameters(o)
                           for k, o in state.optimizers.items()},
        },
    }
    if generator is not None:
        meta["rng"] = {"device": generator.device.type,
                       "state": generator.get_state().tolist()}
    (tmp / "meta.json").write_text(json.dumps(meta))
    if path.exists():
        shutil.rmtree(path)
    tmp.rename(path)
    return path


def load_checkpoint(
    path: Union[str, Path],
    state: TrainState,
    generator: Optional[torch.Generator] = None,
) -> Tuple[TrainState, Manifest, NormalizationStats, dict]:
    """Fill ``state`` (built for the checkpoint's models, on any device)
    and ``generator`` in place from the checkpoint at ``path``; returns
    (state, manifest, normalization, meta).  Raises on a model, tensor,
    EMA or prior that the checkpoint lacks or that the state does not
    hold; a checkpoint without ``priors.safetensors`` (written before the
    port saved them) loads only into a state without the aligner."""
    path = Path(path)
    meta = json.loads((path / "meta.json").read_text())
    saved = {p.stem for p in (path / "models").glob("*.safetensors")}
    if saved != set(state.models):
        raise KeyError(f"checkpoint models {sorted(saved)} differ from the "
                       f"state's {sorted(state.models)}")
    train = meta["train_state"]
    for key, module in state.models.items():
        load_model_safetensors(path / "models" / f"{key}.safetensors", key,
                               module)
        _load_optimizer(key, module, state.optimizers[key],
                        read_safetensors(path / "optim" / f"{key}.safetensors"),
                        train["optimizers"][key])
    # a checkpoint written before the state held the MPD's EMA keeps the
    # state's initial one
    if not set(train["disc_ema"]) <= set(state.disc_ema) or not set(
            state.disc_ema) - set(train["disc_ema"]) <= {"mpd"}:
        raise KeyError(f"checkpoint EMAs {sorted(train['disc_ema'])} differ "
                       f"from the state's {sorted(state.disc_ema)}")
    for key, value in train["disc_ema"].items():
        state.disc_ema[key] = torch.tensor(
            value, dtype=torch.float32, device=state.disc_ema[key].device)
    # a checkpoint written before the label priors were saved: a stage
    # without the aligner keeps the state's initial priors, which it
    # does not use; the alignment stage cannot resume exactly
    priors = (read_safetensors(path / "priors.safetensors")
              if (path / "priors.safetensors").is_file()
              else None if "text_aligner" not in state.models else {})
    if priors is not None and set(priors) != set(state.priors):
        raise KeyError(f"checkpoint priors {sorted(priors)} differ from the "
                       f"state's {sorted(state.priors)}")
    for key, value in (priors or {}).items():
        state.priors[key] = torch.from_numpy(value).to(
            state.priors[key].device)
    state.step = int(train["step"])
    if generator is not None:
        if "rng" not in meta:
            raise KeyError(f"{path}: no generator state saved")
        if meta["rng"]["device"] != generator.device.type:
            raise ValueError(f"{path}: a {meta['rng']['device']} generator "
                             f"state for a {generator.device.type} generator")
        generator.set_state(torch.tensor(meta["rng"]["state"],
                                         dtype=torch.uint8))
    manifest = Manifest()
    manifest.load_state_dict(meta["manifest"])
    return state, manifest, NormalizationStats(**meta["normalization"]), meta
