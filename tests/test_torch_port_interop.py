"""Checkpoint interop of the port with the torch reference, against the JAX
package at a tiny config: the converters, ``import-torch`` (an artifact
from an ``accelerator.save_state`` directory of ``.bin`` or
``.safetensors`` files, and one module with ``--model``), the artifact's
synthesis, ``seed_state_from_torch``, converted SLM weights, and CLI
``test``'s parameter table.

No reference checkout or trained reference checkpoint is needed: the
reference checkpoint is written from the port's seeded modules by
``utils/synthetic.py:write_reference_checkpoint``, under the reference's
torch key names and layouts, and held here to the JAX package's
converters, so a mistake shared by the port's copy of them cannot hide.
"""

from __future__ import annotations

import json
import logging
import wave

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stylish_tts_tpu.models.generator as jgen
from stylish_tts_tpu.config import ModelConfig as JaxModelConfig
from stylish_tts_tpu.export import import_torch as jimport
from stylish_tts_tpu.export.infer import Synthesizer as JaxSynthesizer
from stylish_tts_tpu.export.package import load_inference_params
from stylish_tts_tpu.models import build_models as jax_build_models
from stylish_tts_tpu.models import torch_convert as jconvert
from stylish_tts_tpu.train import torch_seed as jseed
from stylish_tts_tpu.train.checkpoint import (fill_from_flat,
                                              save_model_safetensors)
from stylish_tts_tpu_torch.cli import main
from stylish_tts_tpu_torch.config import dump_json, load_model_config_json
from stylish_tts_tpu_torch.convert import export_flax_params, load_flax_params
from stylish_tts_tpu_torch.export.import_torch import (
    import_torch_checkpoint, load_converted_module)
from stylish_tts_tpu_torch.export.infer import Synthesizer
from stylish_tts_tpu_torch.export.package import load_inference_models
from stylish_tts_tpu_torch.models import torch_convert
from stylish_tts_tpu_torch.train.init import (build_train_state,
                                              build_training_models, init_slm)
from stylish_tts_tpu_torch.train.torch_seed import seed_state_from_torch
from stylish_tts_tpu_torch.utils.synthetic import (reference_state_dict,
                                                   write_reference_checkpoint)
from stylish_tts_tpu_torch.utils.tensorfile import (read_safetensors,
                                                    write_safetensors)
from test_torch_port_helpers import (_inference_shapes, _train_shapes,
                                     assert_close, fill_params, flatten,
                                     train_config, well_posed_prior_inputs)
from torch_port_chain import CHAIN_KEYS, few_threads  # noqa: F401
from torch_port_chain import jax_state

MODELS = tuple(torch_convert.CONVERTERS)
INFERENCE = ("duration_predictor", "pe_text_encoder", "pe_text_style_encoder",
             "pitch_energy_predictor", "speech_predictor")
# weight-normed kernels the converters fold (g * v / |v|): within 1e-6
# relative of the kernel they were written from (measured 1.1e-7)
FOLDED_REL = 1e-6
NOISE_AMPLITUDE = 0.01  # generate_pcph's default
PHONEMES = "ðɪs ɪz"


@torch.no_grad()
def seeded_models(mc, seed: int):
    """The eight converted models with every parameter and buffer drawn
    from ``seed`` (numpy), the heads synthesis needs at a trained model's
    levels, and the F0 head zero: an unvoiced prediction leaves the
    harmonic prior the shared noise, so the port's and the JAX package's
    synthesis agree at the tight tolerance of ``test_torch_port_synthesis``
    (``torch_port_chain.zero_f0_head``)."""
    rng = np.random.default_rng(seed)
    built = build_training_models(mc)
    models = {k: built[k] for k in MODELS}
    for module in models.values():
        for name, t in [*module.named_parameters(), *module.named_buffers()]:
            leaf = name.rsplit(".", 1)[-1]
            normal = torch.from_numpy(
                rng.standard_normal(t.shape).astype(np.float32))
            if leaf in ("gamma", "var") or (leaf in ("weight", "scale")
                                            and t.dim() == 1):
                t.copy_(1.0 + 0.1 * normal)  # norm scales, variances
            elif leaf == "weight":
                t.copy_(normal / t[0].numel() ** 0.5)
            elif leaf == "u":
                t.copy_(normal)
            else:
                t.copy_(0.1 * normal)  # biases, betas, means, sigma
    sp = models["speech_predictor"]
    for head in [sp.prior_encoder, sp.posterior_encoder,
                 *(getattr(sp.flow, f"flow_{i}")
                   for i in range(sp.flow.n_flows))]:
        head.proj_mean.weight.mul_(0.1)
        head.proj_logstd.weight.mul_(0.1)
    sp.generator.amp_output_conv.Conv_0.weight.mul_(0.1)
    f0 = models["pitch_energy_predictor"].f0_proj
    f0.weight.zero_()
    f0.bias.zero_()
    return models


class Recording(dict):
    """A state dict that records which keys are read."""

    def __init__(self, data):
        super().__init__(data)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The seeded models, their reference state dicts, and a save_state
    directory of each file format."""
    root = tmp_path_factory.mktemp("interop")
    mc_jax = train_config()
    mc = load_model_config_json(mc_jax.model_dump_json())
    models = seeded_models(mc, seed=3)
    dirs = {}
    for fmt in ("bin", "safetensors"):
        dirs[fmt] = root / fmt
        write_reference_checkpoint(
            dirs[fmt], models, safetensors=MODELS if fmt != "bin" else ())
    sds = {k: reference_state_dict(k, m) for k, m in models.items()}
    (root / "model.json").write_text(dump_json(mc))
    return dict(root=root, mc_jax=mc_jax, mc=mc, models=models, sds=sds,
                dirs=dirs)


@pytest.fixture(scope="module")
def templates(reference):
    """The JAX package's param (and batch-stat) trees of the eight models,
    by shape: traced, not run."""
    mc_jax = reference["mc_jax"]
    shapes, stat_shapes = _train_shapes(mc_jax.model_dump_json())
    out = {k: (v, None) for k, v in shapes.items() if k in MODELS}
    out["pe_mel_style_encoder"] = (shapes["pe_mel_style_encoder"],
                                   stat_shapes)
    for key, value in _inference_shapes(mc_jax.model_dump_json()).items():
        out[key] = (value, None)
    aligner = jax_build_models(mc_jax)["text_aligner"]
    key = jax.random.PRNGKey(0)
    variables = jax.eval_shape(lambda: aligner.init(
        key, jnp.zeros((1, 32, 80)), jnp.full((1,), 32, jnp.int32)))
    out["text_aligner"] = (variables["params"], variables["batch_stats"])
    return out


def _flat_shapes(tree) -> dict:
    return {k: tuple(v.shape) for k, v in flatten(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                               tree)).items()}


@pytest.mark.parametrize("name", MODELS)
def test_converter_matches_jax_and_fills_the_jax_tree(reference, templates,
                                                      name):
    sd = reference["sds"][name]
    recording = Recording(sd)
    result = jconvert.CONVERTERS[name](recording)
    assert recording.read == set(sd), sorted(set(sd) - recording.read)
    jparams, jstats = result if isinstance(result, tuple) else (result, {})
    params, stats = torch_convert.convert_module(name, sd)
    for got, want in ((params, jparams), (stats, jstats)):
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == np.asarray(want[k]).dtype, k
            assert np.array_equal(got[k], want[k]), (name, k)
    # the JAX tree the output fills: every leaf, at its shape, equal to
    # the flax weights the state dict was written from
    tree, stat_tree = templates[name]
    exported = export_flax_params(name, reference["models"][name])
    for flat, template in ((jparams, tree), (jstats, stat_tree)):
        if template is None:
            assert not flat
            continue
        assert {k: tuple(np.shape(v)) for k, v in flat.items()} == \
            _flat_shapes(template)
        filled = flatten(fill_from_flat(flat, template))
        for k, v in filled.items():
            want = exported[k]
            if np.array_equal(v, want):
                continue
            assert k.endswith("kernel") and name in (
                "pitch_energy_predictor", "speech_predictor"), (name, k)
            err = float(np.abs(v - want).max() / np.abs(want).max())
            assert err <= FOLDED_REL, (name, k, err)


def test_converters_not_ported_name_their_queue_item():
    assert len(MODELS) == 8
    for name in ("mpd", "hubert_encoder", "cfm_mel_decoder", "rmvpe",
                 "wespeaker", "vocos"):
        with pytest.raises(NotImplementedError, match="item 6"):
            torch_convert.converter(name)
    with pytest.raises(ValueError, match="unknown model"):
        torch_convert.converter("nope")


def _same_artifact(port_dir, jax_dir) -> None:
    """File for file: tensors bit-equal, JSON equal as parsed."""
    names = sorted(p.name for p in port_dir.iterdir())
    assert names == sorted(p.name for p in jax_dir.iterdir())
    for name in names:
        if name.endswith(".json"):
            assert json.loads((port_dir / name).read_text()) == json.loads(
                (jax_dir / name).read_text()), name
            continue
        got = read_safetensors(port_dir / name)
        want = read_safetensors(jax_dir / name)
        assert set(got) == set(want), name
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == \
                want[k].shape, (name, k)
            assert np.array_equal(got[k], want[k]), (name, k)


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_import_torch_matches_jax_file_for_file(reference, tmp_path, fmt):
    ckpt = reference["dirs"][fmt]
    port = import_torch_checkpoint(ckpt, tmp_path / "port", reference["mc"])
    jax_out = jimport.import_torch_checkpoint(ckpt, tmp_path / "jax",
                                              reference["mc_jax"])
    _same_artifact(port, jax_out)
    assert json.loads((port / "model_config.json").read_text())[
        "pitch_energy_predictor"]["reference_band_mask"] is True
    assert sorted(p.name for p in port.iterdir()) == sorted(
        [f"{k}.safetensors" for k in INFERENCE]
        + ["text_aligner.safetensors", "model_config.json",
           "metadata.json"])
    # the input config is not changed
    assert reference["mc"].pitch_energy_predictor.reference_band_mask is False


@pytest.mark.parametrize("name", ["text_aligner", "pe_mel_style_encoder"])
def test_import_torch_one_module_through_the_cli(reference, tmp_path, name,
                                                 capsys):
    """``import-torch --model`` on one state-dict file: the JAX package's
    file, tensor for tensor, and the port's module filled from it equals
    the module the file was written from."""
    index = jimport.REFERENCE_SAVE_ORDER.index(name)
    path = reference["dirs"]["bin"] / f"pytorch_model_{index}.bin" \
        if index else reference["dirs"]["bin"] / "pytorch_model.bin"
    main(["import-torch", "--checkpoint", str(path), "--model-config",
          str(reference["root"] / "model.json"), "--out",
          str(tmp_path / "port"), "--model", name, "--device", "cpu"])
    assert f"wrote {tmp_path / 'port'}" in capsys.readouterr().out
    jimport.import_torch_checkpoint(path, tmp_path / "jax",
                                    reference["mc_jax"], single_model=name)
    _same_artifact(tmp_path / "port", tmp_path / "jax")
    module = load_converted_module(tmp_path / "port" / f"{name}.safetensors",
                                   name, build_training_models(
                                       reference["mc"])[name])
    want = reference["models"][name].state_dict()
    for k, t in module.state_dict().items():
        assert torch.equal(t, want[k]), (name, k)
    with pytest.raises(NotImplementedError, match="item 6"):
        import_torch_checkpoint(path, tmp_path / "x", reference["mc"],
                                single_model="mpd")


def test_artifact_speech_matches_jax(reference, tmp_path, capsys):
    """``import-torch`` through the CLI, then ``speak --phonemes`` from the
    artifact, and the synthesis of both packages from their own artifacts
    with the same noise: within 1e-3 of full scale (and 1 LSB of PCM), the
    reference band mask on in both."""
    ckpt = reference["dirs"]["safetensors"]
    art = tmp_path / "port"
    main(["import-torch", "--checkpoint", str(ckpt), "--model-config",
          str(reference["root"] / "model.json"), "--out", str(art),
          "--device", "cpu"])
    jart = jimport.import_torch_checkpoint(ckpt, tmp_path / "jax",
                                           reference["mc_jax"])
    mc, models = load_inference_models(art, "cpu")
    mc_jax = JaxModelConfig.model_validate_json(
        (jart / "model_config.json").read_text())
    assert mc.pitch_energy_predictor.reference_band_mask
    assert mc_jax.pitch_energy_predictor.reference_band_mask
    synth = Synthesizer(mc, models, device="cpu")
    jsynth = JaxSynthesizer(mc_jax, load_inference_params(str(jart), mc_jax))
    durs = synth.predict_durations(PHONEMES)
    np.testing.assert_array_equal(durs, jsynth.predict_durations(PHONEMES))

    # CLI speak: the predicted durations' frames x hop samples
    wav = tmp_path / "speak.wav"
    main(["speak", "--artifact", str(art), "--phonemes", PHONEMES, "--out",
          str(wav), "--device", "cpu"])
    with wave.open(str(wav), "rb") as f:
        assert f.getnframes() == int(durs.sum()) * mc.hop_length
        pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")
    assert np.abs(pcm).max() > 0

    # the same synthesis with dropout, latent noise and prior noise shared
    from stylish_tts_tpu_torch.export.infer import frame_bucket

    frames = frame_bucket(int(durs.sum()))
    # silent under STFT frame 0, whose phase rounding would otherwise set
    # (``well_posed_prior_inputs``)
    _, noise = well_posed_prior_inputs(
        np.zeros((1, frames), np.float32),
        np.random.default_rng(41).standard_normal(
            (1, frames * mc.hop_length)).astype(np.float32))
    sp = synth.models["speech_predictor"]
    forward = sp.forward

    def shared_noise(*args, **kwargs):
        kwargs.update(sample=False, pcph_noise=torch.from_numpy(noise),
                      pcph_phase=torch.zeros(1, 1))
        return forward(*args, **kwargs)

    original = jgen.generate_pcph

    def shared_noise_pcph(f0, voiced, rng, **kwargs):
        kwargs.update(noise_amplitude=0.0, random_init_phase=False)
        return original(f0, voiced, rng, **kwargs) \
            + NOISE_AMPLITUDE * jnp.asarray(noise)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sp, "forward", shared_noise)
        mp.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
        mp.setattr(jax.random, "normal",
                   lambda key, shape=(), dtype=jnp.float32: jnp.zeros(shape,
                                                                      dtype))
        mp.setattr(jgen, "generate_pcph", shared_noise_pcph)
        audio = synth.synthesize(PHONEMES)
        audio_j = jsynth.synthesize(PHONEMES)
    assert audio.shape == audio_j.shape == (durs.sum() * mc.hop_length,)
    assert np.abs(audio_j).max() > 1e-2
    assert_close(audio, audio_j, rel=0.0, abs_=1e-3 + 1 / 32767,
                 what="artifact audio")
    # the band mask the synthesis ran is the reference's: off, the
    # predicted energy moves
    tokens, lengths, _ = synth.encode_batch([PHONEMES])
    dur_vec = torch.zeros(tokens.shape, dtype=torch.long)
    dur_vec[0, : len(durs)] = torch.from_numpy(durs)
    align = synth.duration_processor.batched_duration_to_alignment(
        dur_vec, frames)
    style = synth.style_graph(tokens, lengths)
    pe = models["pitch_energy_predictor"]
    energies = []
    with torch.no_grad():
        pe_enc, _, _ = models["pe_text_encoder"](tokens, lengths)
        for mask in (True, False):
            pe.reference_band_mask = mask
            energies.append(pe(pe_enc, lengths, align, style)[1])
    moved = float((energies[0] - energies[1]).abs().max())
    assert moved > 0.1 * float(energies[0].abs().max()), moved


def test_seed_state_from_torch_matches_jax(reference, tmp_path, caplog):
    """The chain's state seeded from a checkpoint of four models (the
    aligner among them, which the chain's state does not hold): each
    converted model's params and buffers equal the JAX result bit for bit;
    the other models, the optimizers and the CTC priors are unchanged."""
    seeded = ("speech_predictor", "pe_mel_style_encoder", "mrd",
              "text_aligner")
    ckpt = tmp_path / "ckpt"
    write_reference_checkpoint(
        ckpt, {k: reference["models"][k] for k in seeded},
        safetensors=("mrd",))
    mc_jax, mc = reference["mc_jax"], reference["mc"]
    shapes, stat_shapes = _train_shapes(mc_jax.model_dump_json())
    params = {k: fill_params(_inference_shapes(mc_jax.model_dump_json())
                             .get(k, shapes.get(k)), 20 + i)
              for i, k in enumerate(CHAIN_KEYS)}
    stats = fill_params(stat_shapes, 30)
    jstate = jseed.seed_state_from_torch(jax_state(mc_jax, params, stats),
                                         ckpt)
    state = build_train_state(mc, CHAIN_KEYS, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    before = {k: {n: t.clone() for n, t in m.state_dict().items()}
              for k, m in state.models.items()}
    priors = {k: v.clone() for k, v in state.priors.items()}
    with caplog.at_level(logging.INFO):
        seed_state_from_torch(state, ckpt)
    assert "init-torch: skipping text_aligner" in caplog.text
    for key, module in state.models.items():
        now = module.state_dict()
        if key not in seeded:
            for n, t in now.items():
                assert torch.equal(t, before[key][n]), (key, n)
            continue
        flat = flatten(jstate.params[key])
        if key == "pe_mel_style_encoder":
            flat.update(flatten(jstate.batch_stats[key]))
        want = load_flax_params(key, flat, module)
        for n, t in now.items():
            assert torch.equal(t, want[n]), (key, n)
    for key, opt in state.optimizers.items():
        assert not opt.state, key
        assert all(p is q for p, q in zip(opt.param_groups[0]["params"],
                                          state.models[key].parameters()))
    for k, v in priors.items():
        assert torch.equal(state.priors[k], v), k
    assert state.step == 0


def test_slm_weights_file_loads_into_the_slm(reference, tmp_path):
    """A file the JAX package's ``save_model_safetensors`` writes from
    seeded SLM params: ``init_slm`` loads it, and the port's SLM features
    match the JAX SLM's at the SLM parity tolerance
    (``test_torch_port_train_modules.test_slm_matches_jax``); a missing or
    an extra key raises."""
    from stylish_tts_tpu.models.slm import SLMFeatureExtractor as JaxSLM

    mc_jax, mc = reference["mc_jax"], reference["mc"]
    shapes, _ = _train_shapes(mc_jax.model_dump_json())
    params = fill_params(shapes["slm"], 12)
    path = tmp_path / "wavlm.safetensors"
    save_model_safetensors(path, params)
    mc.slm.weights_path = str(path)
    try:
        slm = init_slm(mc, torch.Generator().manual_seed(0))
        audio = (0.1 * np.random.default_rng(12).standard_normal((2, 4000))
                 ).astype(np.float32)
        want = jax.jit(JaxSLM(n_layers=mc.slm.layers).apply)(
            {"params": params}, jnp.asarray(audio))
        with torch.no_grad():
            got = slm(torch.from_numpy(audio))
        assert len(got) == len(want) == mc.slm.layers + 1
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, what=f"hidden state {i}")
        assert not any(p.requires_grad for p in slm.parameters())
        flat = flatten(params)
        for broken, match in (
                ({k: v for k, v in list(flat.items())[1:]}, "left unfilled"),
                ({**flat, "stray/kernel": np.zeros((2, 2), np.float32)},
                 "left unused")):
            write_safetensors(path, broken)
            with pytest.raises(KeyError, match=match):
                init_slm(mc, torch.Generator().manual_seed(0))
    finally:
        mc.slm.weights_path = None


# the JAX package's models the port does not build yet (Queue 1 item 6)
NOT_BUILT = {"mpd"}


def _rows(table: str) -> dict:
    rows = {}
    for line in table.splitlines()[1:]:
        name, count = line.split()
        rows[name] = int(count.replace(",", ""))
    return rows


def test_cli_test_table_matches_jax_param_table(reference, capsys):
    """CLI ``test`` on the CPU: each row of its parameter table equals the
    JAX ``param_table`` row of the same model (the JAX parameters by shape:
    its initialiser traced, not run), and it prints its forward line."""
    from stylish_tts_tpu.train import init as jinit
    from stylish_tts_tpu.utils.harness import param_table as jax_table

    mc_jax = reference["mc_jax"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jinit.jax, "jit", lambda f: lambda *a: jax.eval_shape(
            f, *a))
        variables = jinit.init_model_variables(
            jax_build_models(mc_jax), mc_jax, jax.random.PRNGKey(0))
    want = _rows(jax_table({k: v["params"] for k, v in variables.items()}))
    main(["test", "--model-config", str(reference["root"] / "model.json"),
          "--frames", "24", "--tokens", "8", "--iters", "1", "--device",
          "cpu"])
    out = capsys.readouterr().out.splitlines()
    got = _rows("\n".join(out[:-1]))
    assert out[-1].startswith("speech_predictor forward: ") and \
        out[-1].endswith("x realtime)")
    total = got.pop("TOTAL")
    want.pop("TOTAL")
    assert total == sum(got.values())
    assert set(want) - set(got) == NOT_BUILT and set(got) <= set(want)
    for name, n in got.items():
        assert n == want[name], name
