"""The eight converters the port took last, its conversion scripts and
``models/slm_convert.py`` against the JAX package's, at small widths on
seeded weights (no pretrained checkpoint is in the repository).

For each converter a reference state dict is written from a seeded port
module (``utils/synthetic.py:reference_state_dict``, the reference's key
names and layouts), and both packages convert it: bit-equal, every key
read, and the port's module filled from the result gives every tensor
back.  ``import-torch --model`` runs through the CLI for two of them; each
port script writes what the root JAX script writes from the same file.
The WavLM and HuBERT scripts read a tiny random ``transformers`` model
saved to a local directory, against the JAX package's live conversion.
The port's scripts run with ``transformers`` and ``safetensors`` made
unimportable, as on the card's machine.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stylish_tts_tpu.export import import_torch as jimport
from stylish_tts_tpu.models import slm_convert as jslm
from stylish_tts_tpu.models import torch_convert as jconvert
from stylish_tts_tpu_torch.cli import main
from stylish_tts_tpu_torch.config import dump_json
from stylish_tts_tpu_torch.convert import export_flax_params
from stylish_tts_tpu_torch.dataprep.rmvpe import RMVPE
from stylish_tts_tpu_torch.export.import_torch import (load_converted_module,
                                                       write_converted)
from stylish_tts_tpu_torch.models import slm_convert, torch_convert
from stylish_tts_tpu_torch.models.slm import SLMFeatureExtractor
from stylish_tts_tpu_torch.models.vocos import Vocos
from stylish_tts_tpu_torch.models.wespeaker import SimAMResNet34ASP
from stylish_tts_tpu_torch.scripts import (convert_hubert, convert_rmvpe,
                                           convert_vocos, convert_wavlm,
                                           convert_wespeaker)
from stylish_tts_tpu_torch.train.init import build_training_models
from stylish_tts_tpu_torch.utils.synthetic import (reference_state_dict,
                                                   seeded_rmvpe,
                                                   tiny_model_config,
                                                   write_ssl_checkpoint)
from stylish_tts_tpu_torch.utils.tensorfile import read_safetensors

ROOT = Path(__file__).resolve().parent.parent
EXPERIMENTAL = ("hubert_encoder", "hubert_speech_predictor",
                "hubert_pitch_energy_predictor", "cfm_pitch_predictor",
                "cfm_mel_decoder")
MODELS = EXPERIMENTAL + ("rmvpe", "wespeaker", "vocos")
NARROW_RMVPE = dict(en_out_channels=2, n_blocks=1, inter_layers=1,
                    gru_hidden=16)
# weight-normed kernels the converters fold (g * v / |v|, the speech and
# pitch/energy predictors' convs, the SSL nets' positional conv): within
# this relative gap of the kernel they were written from (measured 7.4e-8)
FOLDED_REL = 1e-6
# the SSL scripts' fold of the positional conv's weight norm in numpy
# against the JAX package's live path, torch's ``_weight_norm``
LIVE_REL = 1e-6


@torch.no_grad()
def _seed(module, rng: np.random.Generator):
    """Every parameter and buffer drawn from ``rng``: norm scales and
    variances 1 + 0.1 N, weights N / sqrt(fan-in), spectral ``u`` N, the
    rest 0.1 N."""
    for name, t in [*module.named_parameters(), *module.named_buffers()]:
        leaf = name.rsplit(".", 1)[-1]
        normal = torch.from_numpy(
            rng.standard_normal(t.shape).astype(np.float32))
        if leaf in ("gamma", "var") or (leaf in ("weight", "scale")
                                        and t.dim() == 1):
            t.copy_(1.0 + 0.1 * normal)
        elif leaf == "weight":
            t.copy_(normal / t[0].numel() ** 0.5)
        elif leaf == "u":
            t.copy_(normal)
        else:
            t.copy_(0.1 * normal)
    return module


def _build(name: str, mc):
    if name == "rmvpe":
        return seeded_rmvpe(5, **NARROW_RMVPE)
    if name == "wespeaker":
        return SimAMResNet34ASP(m_channels=4)
    if name == "vocos":
        return Vocos(dim=32, intermediate_dim=48, n_layers=2)
    return build_training_models(mc, [name])[name]


@pytest.fixture(scope="module")
def seeded():
    """{name: (module, its reference state dict)} at small widths."""
    mc = tiny_model_config()
    rng = np.random.default_rng(7)
    out = {}
    for name in MODELS:
        module = _build(name, mc)
        if name != "rmvpe":  # seeded_rmvpe draws its own
            _seed(module, rng)
        out[name] = (module, reference_state_dict(name, module))
    return out


class Recording(dict):
    """A state dict that records which keys are read: looked up, or handed
    on by ``items()`` (the converters pass a submodule's entries to its own
    converter that way; the round trip then shows they were used)."""

    def __init__(self, data):
        super().__init__(data)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)

    def items(self):
        self.read.update(self.keys())
        return super().items()


def _converter(package, name):
    return (package.convert_rmvpe if name == "rmvpe"
            else package.CONVERTERS[name])


def _split(result):
    return result if isinstance(result, tuple) else (result, {})


def _fresh(name: str):
    """An unfilled module of ``name`` at the widths of ``_build``."""
    if name == "rmvpe":
        return RMVPE(**NARROW_RMVPE)
    return _build(name, tiny_model_config())


def _assert_gives_back(name, module, loaded):
    """``loaded`` holds ``module``'s every tensor: exactly, or a folded
    weight-normed kernel within FOLDED_REL."""
    want, got = module.state_dict(), loaded.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        if torch.equal(got[k], v):
            continue
        assert k.endswith("weight") and name in (
            "hubert_speech_predictor", "hubert_pitch_energy_predictor"), k
        err = float((got[k] - v).abs().max() / v.abs().max())
        assert err <= FOLDED_REL, (name, k, err)


@pytest.mark.parametrize("name", MODELS)
def test_converter_matches_jax_and_round_trips(seeded, tmp_path, name):
    module, sd = seeded[name]
    recording = Recording(sd)
    jparams, jstats = _split(_converter(jconvert, name)(recording))
    assert recording.read == set(sd), sorted(set(sd) - recording.read)
    params, stats = _split(_converter(torch_convert, name)(dict(sd)))
    for got, want in ((params, jparams), (stats, jstats)):
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == np.asarray(want[k]).dtype, k
            assert np.array_equal(got[k], want[k]), (name, k)
    if name in torch_convert.CONVERTERS:
        assert torch_convert.convert_module(name, sd)[0].keys() == \
            params.keys()
    # the import path: the converted file into a fresh module
    write_converted(tmp_path / "m.safetensors", params, stats)
    fresh = _fresh(name)
    load_converted_module(tmp_path / "m.safetensors", name, fresh)
    _assert_gives_back(name, module, fresh)


@pytest.mark.parametrize("name", ["cfm_mel_decoder",
                                  "hubert_speech_predictor"])
def test_import_torch_model_through_the_cli(seeded, tmp_path, capsys, name):
    module, sd = seeded[name]
    src = tmp_path / f"{name}.bin"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, src)
    mc = tiny_model_config()
    (tmp_path / "m.json").write_text(dump_json(mc))
    main(["import-torch", "--checkpoint", str(src), "--model", name,
          "--model-config", str(tmp_path / "m.json"), "--out",
          str(tmp_path / "port"), "--device", "cpu"])
    assert f"wrote {tmp_path / 'port'}" in capsys.readouterr().out
    jimport.import_torch_checkpoint(src, tmp_path / "jax", None,
                                    single_model=name)
    got = read_safetensors(tmp_path / "port" / f"{name}.safetensors")
    want = read_safetensors(tmp_path / "jax" / f"{name}.safetensors")
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    fresh = build_training_models(mc, [name])[name]
    load_converted_module(tmp_path / "port" / f"{name}.safetensors", name,
                          fresh)
    _assert_gives_back(name, module, fresh)


def _root_script(name: str):
    """The JAX package's ``scripts/<name>.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"root_{name}", ROOT / "scripts" / f"{name}.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script


def _without_card_missing_packages(monkeypatch):
    """``transformers`` and ``safetensors`` unimportable, as on the card's
    machine."""
    for mod in [m for m in sys.modules
                if m.split(".")[0] in ("transformers", "safetensors")]:
        monkeypatch.delitem(sys.modules, mod)
    for mod in ("transformers", "safetensors", "safetensors.numpy"):
        monkeypatch.setitem(sys.modules, mod, None)


def _same_file(got_path, want_path, rel: float = 0.0) -> None:
    got, want = read_safetensors(got_path), read_safetensors(want_path)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        if rel == 0.0:
            assert np.array_equal(got[k], want[k]), k
        else:
            assert _rel_err(got[k], want[k]) <= rel, k


def _rel_err(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| over max |want| (0 where both are all zeros)."""
    gap = float(np.abs(got - want).max())
    return gap / float(np.abs(want).max()) if gap else 0.0


@pytest.mark.parametrize("name,port", [("rmvpe", convert_rmvpe),
                                       ("vocos", convert_vocos),
                                       ("wespeaker", convert_wespeaker)])
def test_script_writes_what_the_jax_script_writes(seeded, tmp_path,
                                                  monkeypatch, name, port):
    _, sd = seeded[name]
    state = {k: torch.from_numpy(v) for k, v in sd.items()}
    src = tmp_path / f"{name}.pt"
    # wespeaker's checkpoints hold the state dict under "model"
    torch.save({"model": state} if name == "wespeaker" else state, src)
    jax_out = tmp_path / "jax.safetensors"
    monkeypatch.setattr(sys, "argv", [name, str(src), str(jax_out)])
    assert _root_script(f"convert_{name}").main() == 0
    _without_card_missing_packages(monkeypatch)
    port_out = tmp_path / "port.safetensors"
    assert port.main([str(src), str(port_out)]) == 0
    _same_file(port_out, jax_out)


def _tiny_hf_model(transformers, gated: bool):
    common = dict(hidden_size=32, num_hidden_layers=2,
                  num_attention_heads=4, intermediate_size=48,
                  conv_dim=(16,) * 7, num_conv_pos_embeddings=16,
                  num_conv_pos_embedding_groups=4)
    torch.manual_seed(11)
    if gated:
        model = transformers.WavLMModel(transformers.WavLMConfig(**common))
    else:
        model = transformers.HubertModel(transformers.HubertConfig(**common))
    with torch.no_grad():  # the positional conv's g away from its init
        for name, p in model.named_parameters():
            if "original0" in name or "weight_g" in name:
                p.mul_(1.0 + 0.5 * torch.rand(p.shape))
    return model.eval()


@pytest.mark.parametrize("name,port,gated", [("wavlm", convert_wavlm, True),
                                             ("hubert", convert_hubert,
                                              False)])
def test_ssl_script_matches_the_live_conversion(tmp_path, monkeypatch, name,
                                                port, gated):
    transformers = pytest.importorskip("transformers")
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    model = _tiny_hf_model(transformers, gated)
    model.save_pretrained(str(tmp_path / "hf"))
    live = (jslm.convert_wavlm_model if gated
            else jslm.convert_hubert_model)(model)
    sd = dict(read_safetensors(tmp_path / "hf" / "model.safetensors"))
    exact = jslm.convert_wavlm_state_dict(sd, 2, 4, gated=gated)
    jax_out = tmp_path / "jax.safetensors"
    monkeypatch.setattr(sys, "argv", [name, "--model", str(tmp_path / "hf"),
                                      "--out", str(jax_out)])
    _root_script(f"convert_{name}").main()

    _without_card_missing_packages(monkeypatch)
    port_out = tmp_path / "port.safetensors"
    assert port.main(["--model", str(tmp_path / "hf"), "--out",
                      str(port_out)]) == 0
    got = read_safetensors(port_out)
    assert got.keys() == exact.keys() == live.keys()
    for k in exact:
        assert np.array_equal(got[k], exact[k]), k
        assert _rel_err(got[k], live[k]) <= LIVE_REL, k
    _same_file(port_out, jax_out, rel=LIVE_REL)


@pytest.mark.parametrize("gated", [True, False])
def test_written_ssl_directory_converts_back(tmp_path, gated):
    """The smoke's input to the SSL scripts: a port SLM written as an HF
    checkpoint directory converts back to its own flax names."""
    module = _seed(SLMFeatureExtractor(hidden_dim=32, n_layers=2, n_heads=4,
                                       intermediate_dim=48,
                                       rel_pos_bias=gated),
                   np.random.default_rng(13))
    write_ssl_checkpoint(tmp_path / "hf", module)
    script = convert_wavlm if gated else convert_hubert
    script.main(["--model", str(tmp_path / "hf"), "--out",
                 str(tmp_path / "out.safetensors")])
    got = read_safetensors(tmp_path / "out.safetensors")
    want = export_flax_params("slm", module)
    assert got.keys() == want.keys()
    for k in want:
        if k == "pos_conv/kernel":  # g * v / |v| folded
            assert _rel_err(got[k], want[k]) <= FOLDED_REL
        else:
            assert np.array_equal(got[k], want[k]), k
    with pytest.raises(FileNotFoundError, match="needs a download"):
        slm_convert.convert_checkpoint_directory("microsoft/wavlm-base-plus",
                                                 gated=True)
