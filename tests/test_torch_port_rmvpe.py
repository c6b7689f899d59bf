"""The port's RMVPE pitch net and ``pitch --method rmvpe`` against the JAX
package's, on seeded weights (no pretrained RMVPE checkpoint is in the
repository): the net's forward at narrow widths on a reference state dict
converted by both packages' ``convert_rmvpe``, the mel basis, the cents
decoding and the log-mel, then CLI ``pitch`` on a two-clip dataset from
one converted full-width file against the JAX ``calculate_pitch``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylish_tts_tpu.config import load_config_json as jax_config
from stylish_tts_tpu.config import \
    load_model_config_json as jax_model_config
from stylish_tts_tpu.dataprep import pitch as jpitch
from stylish_tts_tpu.dataprep import rmvpe as jrmvpe
from stylish_tts_tpu.models import torch_convert as jconvert
from stylish_tts_tpu.train.checkpoint import fill_from_flat
from stylish_tts_tpu_torch.cli import main
from stylish_tts_tpu_torch.config import Config, dump_json
from stylish_tts_tpu_torch.convert import load_flax_params
from stylish_tts_tpu_torch.data.audio import wav_info
from stylish_tts_tpu_torch.dataprep import rmvpe as prmvpe
from stylish_tts_tpu_torch.models import torch_convert
from stylish_tts_tpu_torch.scripts import convert_rmvpe
from stylish_tts_tpu_torch.utils.synthetic import (make_synthetic_dataset,
                                                   reference_state_dict,
                                                   seeded_rmvpe,
                                                   tiny_model_config)
from stylish_tts_tpu_torch.utils.tensorfile import read_safetensors

# narrow and shallow, all five levels (tests/test_rmvpe.py's widths)
NARROW = dict(en_out_channels=2, n_blocks=1, inter_layers=1, gru_hidden=16)
# the JAX package's own bound on its RMVPE against the torch reference
# (tests/test_torch_parity.py, test_rmvpe_parity); measured 2.4e-7
SALIENCE_ABS = 5e-4
# the log-mel, both in f32 on the CPU, of a tone over a noise floor 20 dB
# down (the log turns the f32 rounding of a small mel into a large step: at
# a floor 30 dB down the worst bin, at log-mel -6.3, reads 1.05e-4)
MEL_ABS, NOISE_FLOOR = 1e-4, 0.03
# CLI pitch: f0 within F0_REL where every RMVPE frame an output frame
# interpolates has its peak salience more than THRESHOLD_MARGIN from the
# voicing threshold on both sides
F0_REL, THRESHOLD_MARGIN, THRESHOLD = 1e-3, 5e-4, 0.03
# the head's bias lowered so that some frames fall below the threshold
HEAD_SHIFT = -6.2


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_narrow_rmvpe_matches_jax():
    port = seeded_rmvpe(1, **NARROW)
    sd = reference_state_dict("rmvpe", port)
    jparams, jstats = jconvert.convert_rmvpe(sd)
    params, stats = torch_convert.convert_rmvpe(sd)
    for got, want in ((params, jparams), (stats, jstats)):
        assert set(got) == set(want)
        for k in want:
            assert np.array_equal(got[k], want[k]), k
    # the batch norms' statistics are away from the identity
    assert np.abs(stats["enc_0/block_0/bn_0/var"] - 1.0).max() > 0.05

    mel = np.random.default_rng(21).standard_normal((1, 32, 128)).astype(
        np.float32)
    model = jrmvpe.RMVPE(**NARROW)
    variables = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(mel)))
    variables = {"params": fill_from_flat(jparams, variables["params"]),
                 "batch_stats": fill_from_flat(jstats,
                                               variables["batch_stats"])}
    want = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(mel)))

    fresh = prmvpe.RMVPE(**NARROW)
    fresh.load_state_dict(load_flax_params("rmvpe", {**params, **stats},
                                           fresh))
    for k, v in port.state_dict().items():  # the round trip is exact
        assert torch.equal(fresh.state_dict()[k], v), k
    with torch.no_grad():
        got = fresh.eval()(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (1, 32, prmvpe.N_CLASS)
    assert np.abs(got - want).max() <= SALIENCE_ABS
    assert want.std() > 1e-3  # a salience that varies


def test_mel_basis_and_cents_decoding_match_jax():
    assert np.array_equal(prmvpe.rmvpe_mel_basis(), jrmvpe.rmvpe_mel_basis())
    rng = np.random.default_rng(3)
    salience = rng.random((40, prmvpe.N_CLASS)).astype(np.float32) ** 8
    salience[5:9] = 0.01  # below the threshold: unvoiced
    salience[12, 180] = 0.9  # one clear peak
    got = prmvpe.decode_cents(salience)
    assert np.array_equal(got, jrmvpe.decode_cents(salience))
    assert (got[5:9] == 0).all() and (got > 0).sum() >= 30


def test_log_mel_matches_jax():
    t = np.arange(12000) / prmvpe.SAMPLE_RATE
    audio = (0.3 * np.sin(2 * np.pi * 180.0 * t)
             + NOISE_FLOOR * np.random.default_rng(4).standard_normal(t.shape)
             ).astype(np.float32)
    # the JAX class's mel without its net's initialisation
    jax_side = object.__new__(jrmvpe.RMVPEInference)
    from stylish_tts_tpu.ops.stft import stft as jstft

    jax_side._stft = jstft
    jax_side._mel_basis = jnp.asarray(jrmvpe.rmvpe_mel_basis())
    want = np.asarray(jax_side.mel(jnp.asarray(audio[None])))
    port = object.__new__(prmvpe.RMVPEInference)
    port.mel_basis = torch.from_numpy(prmvpe.rmvpe_mel_basis())
    got = port.mel(torch.from_numpy(audio[None])).numpy()
    assert got.shape == want.shape == (1, 12000 // prmvpe.HOP + 1,
                                       prmvpe.N_MELS)
    assert np.abs(got - want).max() <= MEL_ABS


def test_reflect_frames_is_numpys_reflect():
    for n, total in ((31, 32), (33, 64), (5, 32), (2, 7)):
        want = np.pad(np.arange(n), (0, total - n), mode="reflect")
        assert np.array_equal(prmvpe.reflect_frames(n, total).numpy(), want)


def _recording(module, monkeypatch) -> list:
    """Record every salience ``module.decode_cents`` is given."""
    seen = []
    decode = module.decode_cents

    def recording(salience, *args, **kwargs):
        seen.append(np.asarray(salience))
        return decode(salience, *args, **kwargs)

    monkeypatch.setattr(module, "decode_cents", recording)
    return seen


def _clear_frames(n_out: int, peaks: list) -> np.ndarray:
    """Output frames whose interpolated RMVPE frames all have their peak
    salience clear of the threshold in every list of ``peaks``."""
    clear = np.all([np.abs(p - THRESHOLD) > THRESHOLD_MARGIN for p in peaks],
                   axis=0)
    pos = np.linspace(0, 1, n_out) * (clear.shape[0] - 1)
    return clear[np.floor(pos).astype(int)] & clear[np.ceil(pos).astype(int)]


def test_cli_pitch_rmvpe_matches_jax(tmp_path, capsys, monkeypatch):
    model = seeded_rmvpe(2)
    with torch.no_grad():
        model.head.bias.add_(HEAD_SHIFT)
    src, weights = tmp_path / "rmvpe.pt", tmp_path / "rmvpe.safetensors"
    torch.save({k: torch.from_numpy(v) for k, v in
                reference_state_dict("rmvpe", model).items()}, src)
    assert convert_rmvpe.main([str(src), str(weights)]) == 0
    make_synthetic_dataset(tmp_path / "data", n_segments=2, n_val=1)
    cfg = Config()
    cfg.dataset.path = str(tmp_path / "data")
    mc = tiny_model_config()
    (tmp_path / "c.json").write_text(dump_json(cfg))
    (tmp_path / "m.json").write_text(dump_json(mc))

    # the JAX net's variables only as the template its converted file
    # fills: traced for their shapes, not initialised eagerly (25 s)
    init = jrmvpe.RMVPE.init
    monkeypatch.setattr(jrmvpe.RMVPE, "init", lambda self, *a, **k:
                        jax.eval_shape(lambda: init(self, *a, **k)))
    jax_seen = _recording(jrmvpe, monkeypatch)
    jpitch.calculate_pitch(jax_config(dump_json(cfg)),
                           jax_model_config(dump_json(mc)), method="rmvpe",
                           rmvpe_weights=str(weights))
    want = read_safetensors(tmp_path / "data" / "pitch.safetensors")
    port_seen = _recording(prmvpe, monkeypatch)
    main(["pitch", "--config", str(tmp_path / "c.json"), "--model-config",
          str(tmp_path / "m.json"), "--method", "rmvpe", "--rmvpe-weights",
          str(weights), "--device", "cpu"])
    assert "wrote pitch.safetensors (2 segments)" in capsys.readouterr().out
    got = read_safetensors(tmp_path / "data" / "pitch.safetensors")

    assert got.keys() == want.keys() and len(got) == 2
    kept = voiced = 0
    # calculate_pitch's order: the val list (seg_1), then train (seg_0)
    for i, name in enumerate(("seg_1.wav", "seg_0.wav")):
        n_samples = wav_info(tmp_path / "data" / "wav24" / name).frames
        assert got[name].shape == want[name].shape == (
            n_samples // mc.hop_length + 1,)
        assert port_seen[i].shape == jax_seen[i].shape
        assert np.abs(port_seen[i] - jax_seen[i]).max() <= SALIENCE_ABS
        mask = _clear_frames(got[name].shape[0], [port_seen[i].max(1),
                                                  jax_seen[i].max(1)])
        g, w = got[name][mask], want[name][mask]
        assert np.array_equal(g > 0, w > 0)
        assert np.all(np.abs(g - w) <= F0_REL * np.abs(w))
        kept += int(mask.sum())
        voiced += int((w > 0).sum())
    total = sum(v.shape[0] for v in want.values())
    assert kept >= 0.5 * total and 0 < voiced < kept  # both kinds seen
