"""The training runtime's state on the card: a checkpoint round trip of a
CUDA generator's state and of a train state that lives on the card.

Imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_port_runtime_cuda.py

Without a card every test skips.
"""

from __future__ import annotations

import pytest
import torch

from stylish_tts_tpu_torch.config import Config, dump_json
from stylish_tts_tpu_torch.train.checkpoint import (Manifest,
                                                    NormalizationStats,
                                                    load_checkpoint,
                                                    save_checkpoint)
from stylish_tts_tpu_torch.train.init import build_train_state
from stylish_tts_tpu_torch.train.optim import apply_updates
from stylish_tts_tpu_torch.utils.synthetic import tiny_model_config

KEYS = ("speech_predictor", "pitch_energy_predictor", "pe_text_encoder",
        "pe_mel_style_encoder", "mrd", "duration_predictor",
        "pe_text_style_encoder")
TRAINED = ("speech_predictor", "pe_mel_style_encoder", "mrd")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the state lives on the card")


def _state(seed: int, device: str):
    return build_train_state(tiny_model_config(), KEYS, device=device,
                             generator=torch.Generator().manual_seed(seed))


def _trained_state(seed: int):
    """A card state whose trained models took two AdamW updates on seeded
    gradients, with a moved EMA and step."""
    state = _state(seed, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for _ in range(2):
        for key in TRAINED:
            for p in state.models[key].parameters():
                p.grad = torch.randn(p.shape, generator=gen, device="cuda")
            apply_updates(state.optimizers[key], 1e-3)
    state.disc_ema["mrd"] = torch.tensor(1.37, device="cuda")
    state.step = 2
    return state


def _save(state, path, generator=None):
    return save_checkpoint(path, "ckpt", state, Manifest(current_step=2),
                           NormalizationStats(), dump_json(Config()),
                           dump_json(tiny_model_config()), generator)


def _assert_states_equal(got, want):
    for key in KEYS:
        g, w = got.models[key].state_dict(), want.models[key].state_dict()
        assert g.keys() == w.keys()
        for name in w:
            assert torch.equal(g[name].cpu(), w[name].cpu()), f"{key}.{name}"
        g, w = got.optimizers[key].state_dict(), \
            want.optimizers[key].state_dict()
        assert g["param_groups"] == w["param_groups"]
        assert g["state"].keys() == w["state"].keys()
        assert bool(w["state"]) == (key in TRAINED)
        for index, entry in w["state"].items():
            for name, value in entry.items():
                assert torch.equal(g["state"][index][name].cpu(),
                                   value.cpu()), f"{key} {index} {name}"
    assert torch.equal(got.disc_ema["mrd"].cpu(), want.disc_ema["mrd"].cpu())
    assert got.step == want.step


@pytest.mark.cuda
def test_cuda_generator_state_round_trip(cuda, tmp_path):
    state = _state(0, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    torch.rand(1000, generator=gen, device="cuda")  # move the offset
    path = _save(state, tmp_path, gen)
    want = torch.rand(64, generator=gen, device="cuda")
    fresh = torch.Generator(device="cuda").manual_seed(99)
    load_checkpoint(path, _state(1, "cuda"), fresh)
    assert torch.equal(torch.rand(64, generator=fresh, device="cuda"), want)
    with pytest.raises(ValueError):  # a CUDA state for a CPU generator
        load_checkpoint(path, _state(1, "cuda"), torch.Generator())


@pytest.mark.cuda
def test_card_state_round_trip(cuda, tmp_path):
    state = _trained_state(0)
    path = _save(state, tmp_path)
    fresh = _state(5, "cuda")
    load_checkpoint(path, fresh)
    _assert_states_equal(fresh, state)
    for key in KEYS:  # loaded in place: still on the card
        assert all(p.is_cuda for p in fresh.models[key].parameters())
        for entry in fresh.optimizers[key].state.values():
            assert entry["exp_avg"].is_cuda and entry["exp_avg_sq"].is_cuda
    assert fresh.disc_ema["mrd"].is_cuda


@pytest.mark.cuda
def test_card_checkpoint_loads_on_the_cpu(cuda, tmp_path):
    state = _trained_state(1)
    path = _save(state, tmp_path)
    on_cpu = _state(6, "cpu")
    load_checkpoint(path, on_cpu)
    _assert_states_equal(on_cpu, state)
