"""The port's training runtime on the CPU, against the JAX package.

The data path (WAV I/O, dataset, collate, sampler, batch manager) runs on
datasets written by both packages' generators and must give the JAX
package's batches bit for bit. The safetensors writer is held against the
library, the checkpoint against its own round trip and a resumed run
against the uninterrupted one, all exactly; the packaged artifact is read
by both packages. The inverse weight map has its own file
(``test_torch_port_runtime_convert.py``). Everything runs at the tiny
model config on the plain kernel paths, seeded with numpy and torch
generators.
"""

from __future__ import annotations

import copy
import importlib
import json
import shutil
import wave

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from stylish_tts_tpu.utils.synthetic import tiny_model_config as jax_tiny
from stylish_tts_tpu_torch.config import Config, dump_json
from stylish_tts_tpu_torch.convert import export_flax_params
from stylish_tts_tpu_torch.train.checkpoint import (Manifest,
                                                    NormalizationStats,
                                                    load_checkpoint,
                                                    save_checkpoint)
from stylish_tts_tpu_torch.utils.synthetic import tiny_model_config
from stylish_tts_tpu_torch.utils.tensorfile import (read_safetensors,
                                                    write_safetensors)
from test_torch_port_helpers import flatten

PACKAGES = {"jax": "stylish_tts_tpu", "port": "stylish_tts_tpu_torch"}
# the acoustic stage's models and the two other inference models: a state
# that can be packaged
KEYS = ("speech_predictor", "pitch_energy_predictor", "pe_text_encoder",
        "pe_mel_style_encoder", "mrd", "duration_predictor",
        "pe_text_style_encoder")


def _module(pkg: str, name: str):
    return importlib.import_module(f"{PACKAGES[pkg]}.{name}")


# --------------------------------------------------------------------------- #
# the data path


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The same synthetic dataset written by each package: 14 segments of
    0.7-1.3 s, over four time bins."""
    roots = {}
    for pkg in PACKAGES:
        root = tmp_path_factory.mktemp(f"dataset_{pkg}")
        _module(pkg, "utils.synthetic").make_synthetic_dataset(
            root, n_segments=14, seconds=1.0)
        roots[pkg] = root
    return roots


def _dataset(pkg: str, root):
    ds = _module(pkg, "data.dataset")
    mc = _module(pkg, "config").ModelConfig()
    return ds.FilePathDataset(
        data_list=ds.get_data_path_list(root / "train-list.txt"),
        root_path=root / "wav24",
        text_cleaner=_module(pkg, "text").TextCleaner(),
        model_config=mc, pitch_path=str(root / "pitch.safetensors"),
        alignment_path=str(root / "alignment.safetensors"))


def _manager(pkg: str, root, out, **kwargs):
    return _module(pkg, "data.batch_manager").BatchManager(
        _dataset(pkg, root), out, "acoustic", probe_batch_max=1,
        num_workers=2, **kwargs)


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key, value in w.items():
            if isinstance(value, np.ndarray):
                assert g[key].dtype == value.dtype, key
                assert np.array_equal(g[key], value), key
            else:
                assert g[key] == value, key


def test_synthetic_datasets_match(datasets):
    jax_root, port_root = datasets["jax"], datasets["port"]
    for name in ("train-list.txt", "val-list.txt"):
        assert (port_root / name).read_text() == (jax_root / name).read_text()
    wavs = sorted(p.name for p in (jax_root / "wav24").iterdir())
    assert wavs == sorted(p.name for p in (port_root / "wav24").iterdir())
    for name in wavs:
        assert (port_root / "wav24" / name).read_bytes() == \
            (jax_root / "wav24" / name).read_bytes()
    for name in ("pitch.safetensors", "alignment.safetensors"):
        want, got = read_safetensors(jax_root / name), \
            read_safetensors(port_root / name)
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype
            assert np.array_equal(got[key], want[key])


@pytest.mark.parametrize("writer,skip,divisor", [
    ("jax", 0, 1), ("jax", 2, 1), ("port", 0, 1), ("port", 2, 1),
    ("port", 1, 3)])
def test_epoch_batches_match_jax(datasets, tmp_path, writer, skip, divisor):
    """The port's epoch iterator on either package's dataset yields the
    JAX iterator's batches: keys, dtypes, every array, the bin."""
    kw = dict(stage="acoustic", epoch=2, seed=3, skip_batches=skip)
    want = list(_manager("jax", datasets["jax"], tmp_path / "jax",
                         divisor=divisor).epoch_iterator(**kw))
    port = _manager("port", datasets[writer], tmp_path / "port",
                    divisor=divisor)
    got = list(port.epoch_iterator(**kw))
    assert len(want) == port.steps_per_epoch() - skip >= 2
    _assert_batches_equal(got, want)


def test_iterator_closed_early_stops_its_threads(datasets, tmp_path):
    import threading

    manager = _manager("port", datasets["port"], tmp_path)
    before = threading.active_count()
    it = manager.epoch_iterator(stage="acoustic", epoch=1)
    next(it)
    it.close()
    assert threading.active_count() == before


def test_time_bins_and_plan_match_jax(datasets, tmp_path):
    jax_m = _manager("jax", datasets["jax"], tmp_path / "jax")
    port_m = _manager("port", datasets["port"], tmp_path / "port")
    assert port_m.time_bins == jax_m.time_bins
    assert port_m.seconds_per_bin == jax_m.seconds_per_bin
    assert len(port_m.time_bins) >= 3
    assert port_m.batch_sizes == jax_m.batch_sizes
    assert port_m.batch_file().read_text() == jax_m.batch_file().read_text()
    for divisor in (1, 3):
        jax_m.divisor = port_m.divisor = divisor
        assert port_m.steps_per_epoch() == jax_m.steps_per_epoch()
        for b in port_m.time_bins:
            assert port_m.get_batch_size(b) == jax_m.get_batch_size(b)
    # an edit is persisted and read back in place of a new plan
    port_m.set_batch_size(2, 7)
    again = _manager("port", datasets["port"], tmp_path / "port")
    assert again.batch_sizes == port_m.batch_sizes
    assert again.get_batch_size(2) == 7


def test_bins_and_buckets_match_jax():
    jax_ds, port_ds = _module("jax", "data.dataset"), \
        _module("port", "data.dataset")
    assert (port_ds.MAX_PHONEMES, port_ds.TEXT_BUCKET) == \
        (jax_ds.MAX_PHONEMES, jax_ds.TEXT_BUCKET)
    for n in range(0, 60000, 37):
        assert port_ds.get_time_bin(n, 300) == jax_ds.get_time_bin(n, 300)
    for b in range(-1, 40):
        assert port_ds.get_frame_count(b) == jax_ds.get_frame_count(b)
    for n in range(0, 700):
        assert port_ds.text_bucket_length(n) == jax_ds.text_bucket_length(n)


def test_jitter_and_alignment_match_jax():
    jax_c, port_c = _module("jax", "data.collate"), \
        _module("port", "data.collate")
    from stylish_tts_tpu.duration import duration_to_alignment_np as jax_align
    from stylish_tts_tpu_torch.duration import duration_to_alignment_np

    rng = np.random.default_rng(0)
    for seed in range(4):
        duration = np.stack([
            rng.integers(1, 9, 30).astype(np.float32),
            0.5 * rng.random(30).astype(np.float32),
            0.5 * rng.random(30).astype(np.float32)])
        want = jax_c.jitter_durations(duration, np.random.default_rng(seed))
        got = port_c.jitter_durations(duration, np.random.default_rng(seed))
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert not np.array_equal(got, duration[0])  # the jitter moved some
        frames = int(got.sum()) + 5
        a, b = duration_to_alignment_np(got, frames), jax_align(got, frames)
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("stage,jitter", [("acoustic", True),
                                          ("acoustic", False),
                                          ("alignment", True)])
def test_items_and_collate_match_jax(datasets, stage, jitter):
    jax_ds = _dataset("jax", datasets["jax"])
    port_ds = _dataset("port", datasets["port"])
    idxs = [4, 1, 7]
    jax_items = [jax_ds.load_item(i) for i in idxs]
    port_items = [port_ds.load_item(i) for i in idxs]
    for g, w in zip(port_items, jax_items):
        assert g.keys() == w.keys()
        for key, value in w.items():
            if isinstance(value, np.ndarray):
                assert g[key].dtype == value.dtype
                assert np.array_equal(g[key], value), key
            else:
                assert g[key] == value, key
    # one bin per batch: the frame counts of the items
    frames = jax_items[0]["frame_count"]
    same = [i for i, it in enumerate(jax_items) if it["frame_count"] == frames]
    want = _module("jax", "data.collate").collate(
        [jax_items[i] for i in same], stage=stage,
        rng=np.random.default_rng(11), jitter=jitter)
    got = _module("port", "data.collate").collate(
        [port_items[i] for i in same], stage=stage,
        rng=np.random.default_rng(11), jitter=jitter)
    _assert_batches_equal([got], [want])


SAMPLER_BINS = {0: list(range(0, 7)), 3: list(range(7, 20)),
                5: list(range(20, 23)), 9: list(range(23, 24))}
SAMPLER_SIZES = {0: 2, 3: 4, 5: 1, 9: 0}


@pytest.mark.parametrize("kwargs", [
    dict(), dict(shuffle=False), dict(drop_last=True), dict(seed=5, epoch=3),
    dict(force_bin=3), dict(force_batch_size=3)], ids=str)
def test_sampler_order_matches_jax(kwargs):
    samplers = [
        _module(pkg, "data.sampler").DynamicBatchSampler(
            SAMPLER_BINS, SAMPLER_SIZES.get, **kwargs) for pkg in PACKAGES]
    want, got = (list(s) for s in samplers)
    assert got == want and len(got) >= 4
    assert len(samplers[1]) == len(samplers[0])


def _write_test_wavs(root):
    rng = np.random.default_rng(0)
    x = 0.5 * rng.standard_normal(7001).clip(-1, 1)
    cases = {
        "i16_24k.wav": (24000, (x * 32767).astype(np.int16)),
        "i16_16k.wav": (16000, (x * 32767).astype(np.int16)),
        "i32_24k.wav": (24000, (x * 2**31 * 0.9).astype(np.int32)),
        "f32_22k.wav": (22050, x.astype(np.float32)),
        "i16_stereo.wav": (24000, np.stack([x, -x], 1).__mul__(32767)
                           .astype(np.int16)),
    }
    for name, (sr, data) in cases.items():
        wavfile.write(root / name, sr, data)
    return cases


def test_read_wav_matches_jax(tmp_path):
    jax_a, port_a = _module("jax", "data.audio"), _module("port", "data.audio")
    for name, (sr, data) in _write_test_wavs(tmp_path).items():
        path = tmp_path / name
        got, want = port_a.read_wav(path, 24000), jax_a.read_wav(path, 24000)
        assert got.dtype == want.dtype == np.float32, name
        assert np.array_equal(got, want), name
        info = port_a.wav_info(path)
        assert (info.frames, info.samplerate) == (data.shape[0], sr)
        if data.dtype == np.int16:  # the stdlib reader: PCM only
            ref = jax_a.wav_info(path)
            assert (info.frames, info.samplerate) == (ref.frames,
                                                      ref.samplerate)
            with wave.open(str(path)) as f:
                assert info.channels == f.getnchannels()


# --------------------------------------------------------------------------- #
# safetensors and configs


def _tensors():
    rng = np.random.default_rng(3)
    return {
        "a/kernel": rng.standard_normal((3, 4, 5)).astype(np.float32),
        "b/bias": rng.standard_normal(7).astype(np.float64),
        "c": rng.integers(-5, 5, (2, 3)).astype(np.int32),
        "d/scalar": np.array(2.5, np.float32),
        "e/empty": np.zeros((0, 3), np.float32),
        "f/step": np.array(17, np.int64),
        "g/mask": rng.random((4, 2)) > 0.5,
        "h/half": rng.standard_normal((2, 2)).astype(np.float16),
        "i/bytes": rng.integers(0, 255, 9).astype(np.uint8),
    }


@pytest.mark.parametrize("direction", ["port_to_library", "library_to_port"])
def test_safetensors_files_cross(tmp_path, direction):
    from safetensors.numpy import load_file, save_file

    tensors = _tensors()
    path = tmp_path / "x.safetensors"
    if direction == "port_to_library":
        write_safetensors(path, tensors)
        got = load_file(str(path))
    else:
        save_file(tensors, str(path), metadata={"format": "np"})
        got = read_safetensors(path)
    assert got.keys() == tensors.keys()
    for name, want in tensors.items():
        assert got[name].dtype == want.dtype, name
        assert got[name].shape == want.shape, name
        assert np.array_equal(got[name], want), name


def test_written_header_is_padded_and_ordered(tmp_path):
    import struct

    path = tmp_path / "x.safetensors"
    write_safetensors(path, _tensors())
    data = path.read_bytes()
    (n,) = struct.unpack("<Q", data[:8])
    assert n % 8 == 0
    header = json.loads(data[8:8 + n])
    offsets = [header[k]["data_offsets"] for k in sorted(header)]
    assert offsets[0][0] == 0 and offsets[-1][1] == len(data) - 8 - n
    assert all(a[1] == b[0] for a, b in zip(offsets, offsets[1:]))


@pytest.mark.parametrize("schema", ["model", "tiny model", "run"])
def test_dump_json_matches_pydantic(schema):
    from stylish_tts_tpu.config import Config as JaxConfig
    from stylish_tts_tpu.config import ModelConfig as JaxModelConfig
    from stylish_tts_tpu_torch.config import ModelConfig

    port, ref = {"model": (ModelConfig(), JaxModelConfig()),
                 "tiny model": (tiny_model_config(), jax_tiny()),
                 "run": (Config(), JaxConfig())}[schema]
    assert dump_json(port) == ref.model_dump_json()


# --------------------------------------------------------------------------- #
# checkpoint, resume and the artifact


def _tensor_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()
            if isinstance(v, np.ndarray)}


def _state(mc, seed):
    from stylish_tts_tpu_torch.train.init import build_train_state

    return build_train_state(mc, KEYS, device="cpu",
                             generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Four acoustic steps straight through (run A), and two, a checkpoint,
    a fresh state from another seed loaded from it and two more with
    ``skip_batches=2`` (run B); batches of 2 from the epoch iterator."""
    from stylish_tts_tpu_torch.data.batch_manager import BatchManager
    from stylish_tts_tpu_torch.train.init import init_slm
    from stylish_tts_tpu_torch.train.stages import StageContext, make_train_step
    from stylish_tts_tpu_torch.utils.synthetic import make_synthetic_dataset

    tmp = tmp_path_factory.mktemp("run")
    make_synthetic_dataset(tmp / "data", n_segments=10)
    mc = tiny_model_config()
    mc.slm.layers = 1
    (tmp / "out").mkdir()
    (tmp / "out" / "acoustic_batch_sizes.json").write_text('{"0": 2}')
    manager = BatchManager(_dataset("port", tmp / "data"), tmp / "out",
                           "acoustic", num_workers=2)
    assert manager.batch_sizes == {"0": 2} and manager.steps_per_epoch() == 4
    cfg = Config()
    ctx = StageContext(model_config=mc, config=cfg, mel_mean=-4.0,
                       mel_std=4.0, step_limit=100,
                       slm=init_slm(mc, torch.Generator().manual_seed(9)))
    step = make_train_step("acoustic", ctx, 1e-3)

    a, gen_a = _state(mc, 1), torch.Generator().manual_seed(5)
    for i, batch in enumerate(manager.epoch_iterator(stage="acoustic",
                                                     epoch=1)):
        if i == 2:
            ckpt = save_checkpoint(
                tmp / "ckpt", "checkpoint_00001_step_000000002", a,
                Manifest(current_epoch=1, current_step=2, steps_per_epoch=4,
                         current_total_step=2, stage="acoustic"),
                NormalizationStats(mel_log_mean=-3.5, frames=12), dump_json(cfg),
                dump_json(mc), generator=gen_a)
            saved, saved_rng = copy.deepcopy(a), gen_a.get_state()
        step(a, _tensor_batch(batch), gen_a)

    b, gen_b = _state(mc, 2), torch.Generator().manual_seed(77)
    _, manifest, norm, meta = load_checkpoint(ckpt, b, gen_b)
    loaded, loaded_rng = copy.deepcopy(b), gen_b.get_state()
    for batch in manager.epoch_iterator(stage="acoustic", epoch=1,
                                        skip_batches=manifest.current_step):
        step(b, _tensor_batch(batch), gen_b)
    return dict(mc=mc, ckpt=ckpt, a=a, gen_a=gen_a, b=b, gen_b=gen_b,
                saved=saved, saved_rng=saved_rng, loaded=loaded,
                loaded_rng=loaded_rng, manifest=manifest, norm=norm,
                meta=meta, tmp=tmp)


def _assert_states_equal(got, want):
    assert got.models.keys() == want.models.keys()
    for key in want.models:
        g, w = got.models[key].state_dict(), want.models[key].state_dict()
        assert g.keys() == w.keys()
        for name in w:
            assert torch.equal(g[name], w[name]), f"{key}.{name}"
        g, w = got.optimizers[key].state_dict(), \
            want.optimizers[key].state_dict()
        assert g["param_groups"] == w["param_groups"], key
        assert g["state"].keys() == w["state"].keys(), key
        for index, entry in w["state"].items():
            assert g["state"][index].keys() == entry.keys()
            for name, value in entry.items():
                assert g["state"][index][name].dtype == value.dtype
                assert torch.equal(g["state"][index][name], value), \
                    f"{key} moment {index} {name}"
    assert got.disc_ema.keys() == want.disc_ema.keys()
    for key in want.disc_ema:
        assert torch.equal(got.disc_ema[key], want.disc_ema[key])
    assert got.step == want.step


def test_checkpoint_round_trip_is_exact(run):
    saved = run["saved"]
    assert saved.step == 2
    # every trained model has its moments: the round trip carries them
    for key in ("speech_predictor", "mrd"):
        assert saved.optimizers[key].state
    _assert_states_equal(run["loaded"], saved)
    assert torch.equal(run["loaded_rng"], run["saved_rng"])
    assert run["manifest"] == Manifest(
        current_epoch=1, current_step=2, steps_per_epoch=4,
        current_total_step=2, stage="acoustic")
    assert run["norm"] == NormalizationStats(mel_log_mean=-3.5, frames=12)
    assert run["meta"]["model_config"] == json.loads(dump_json(run["mc"]))
    assert run["meta"]["config"] == json.loads(dump_json(Config()))
    layout = sorted(str(p.relative_to(run["ckpt"]))
                    for p in run["ckpt"].rglob("*") if p.is_file())
    assert layout == sorted(["meta.json"] + [
        f"{d}/{k}.safetensors" for d in ("models", "optim") for k in KEYS])


def _corrupt(path, what: str):
    def edit(file, fn):
        tensors = read_safetensors(file)
        fn(tensors)
        write_safetensors(file, tensors)

    models, optim = path / "models", path / "optim"
    if what == "model tensor missing":
        edit(models / "mrd.safetensors",
             lambda t: t.pop("disc_1/conv_2/bias"))
    elif what == "model tensor unused":
        edit(models / "pe_text_encoder.safetensors",
             lambda t: t.update(extra=np.zeros(3, np.float32)))
    elif what == "moment missing":
        edit(optim / "speech_predictor.safetensors",
             lambda t: t.pop(sorted(k for k in t if k.endswith("exp_avg"))[0]))
    elif what == "moment unused":
        edit(optim / "mrd.safetensors",
             lambda t: t.update({"nowhere/exp_avg": np.zeros(2, np.float32)}))
    elif what == "model file missing":
        (models / "duration_predictor.safetensors").unlink()
    elif what == "EMA unused":
        meta = json.loads((path / "meta.json").read_text())
        meta["train_state"]["disc_ema"]["mpd"] = 1.0
        (path / "meta.json").write_text(json.dumps(meta))


@pytest.mark.parametrize("what", [
    "model tensor missing", "model tensor unused", "moment missing",
    "moment unused", "model file missing", "EMA unused"])
def test_checkpoint_load_raises_on_missing_or_unused(run, tmp_path, what):
    path = tmp_path / "ckpt"
    shutil.copytree(run["ckpt"], path)
    _corrupt(path, what)
    with pytest.raises(KeyError):
        load_checkpoint(path, _state(run["mc"], 3))


def test_resume_replays_uninterrupted_run(run):
    """4 steps straight == 2 steps, save, load into a state drawn from
    another seed, 2 steps on ``skip_batches=2``: every parameter, buffer,
    moment, the EMA and the generator, exactly."""
    a, b = run["a"], run["b"]
    assert a.step == b.step == 4
    moved = [not torch.equal(p, q) for p, q in zip(
        a.models["speech_predictor"].parameters(),
        run["saved"].models["speech_predictor"].parameters())]
    assert any(moved)
    _assert_states_equal(b, a)
    assert torch.equal(run["gen_b"].get_state(), run["gen_a"].get_state())


@pytest.fixture(scope="module")
def artifact(run, tmp_path_factory):
    from stylish_tts_tpu_torch.export.package import package_inference_artifact

    return package_inference_artifact(
        run["ckpt"], tmp_path_factory.mktemp("artifact") / "art")


def test_artifact_read_by_both_packages(run, artifact):
    from stylish_tts_tpu.config import ModelConfig as JaxModelConfig
    from stylish_tts_tpu.export.package import load_inference_params
    from stylish_tts_tpu_torch.export.package import load_inference_models
    from stylish_tts_tpu_torch.models import INFERENCE_MODELS

    saved = run["saved"]
    mc, models = load_inference_models(artifact, "cpu")
    assert dump_json(mc) == dump_json(run["mc"])
    for key in INFERENCE_MODELS:
        want = saved.models[key].state_dict()
        got = models[key].state_dict()
        assert got and set(got) <= set(want)
        for name, value in got.items():
            assert torch.equal(value, want[name]), f"{key}.{name}"
    assert not any(k.startswith("posterior_encoder.")
                   for k in models["speech_predictor"].state_dict())

    jax_mc = JaxModelConfig.model_validate_json(
        (artifact / "model_config.json").read_text())
    params = load_inference_params(str(artifact), jax_mc)
    for key in INFERENCE_MODELS:
        want = export_flax_params(key, saved.models[key])
        got = flatten(params[key])
        assert got.keys() == want.keys(), key
        for name, value in want.items():
            assert got[name].shape == value.shape
            assert np.array_equal(got[name], value), f"{key}/{name}"
    metadata = json.loads((artifact / "metadata.json").read_text())
    assert metadata == {"normalization": run["meta"]["normalization"],
                        "manifest": run["meta"]["manifest"]}


def test_cli_convert_writes_the_artifact(run, artifact, tmp_path, capsys):
    from stylish_tts_tpu_torch.cli import main

    out = tmp_path / "cli_art"
    main(["convert", "--checkpoint", str(run["ckpt"]), "--out", str(out)])
    assert f"wrote {out}" in capsys.readouterr().out
    names = sorted(p.name for p in artifact.iterdir())
    assert names == sorted(p.name for p in out.iterdir())
    assert len(names) == 7
    for name in names:
        assert (out / name).read_bytes() == (artifact / name).read_bytes()
