"""The multi-period discriminator of the port against the JAX package's:
scores and feature maps on the same weights, carried by name, and the
reference converter ``convert_mpd`` on a seeded reference state dict,
bit-equal to the JAX converter's output; ``import-torch --model mpd``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylish_tts_tpu.models import torch_convert as jconvert
from stylish_tts_tpu.models.discriminator import \
    MultiPeriodDiscriminator as JaxMPD
from stylish_tts_tpu_torch.cli import main
from stylish_tts_tpu_torch.export.import_torch import load_converted_module
from stylish_tts_tpu_torch.models import torch_convert
from stylish_tts_tpu_torch.models.discriminator import \
    MultiPeriodDiscriminator
from stylish_tts_tpu_torch.train.init import init_params
from stylish_tts_tpu_torch.utils.synthetic import reference_state_dict
from test_torch_port_helpers import (assert_close, fill_params, load_port,
                                     param_shapes)
from torch_port_chain import few_threads  # noqa: F401

T = 1000  # not a multiple of 3, 7 or 11: those periods reflect-pad


@pytest.fixture(scope="module")
def seeded_mpd():
    """The port's MPD drawn from a seed (the flax initialisers'
    distributions) and its reference state dict."""
    mpd = init_params(MultiPeriodDiscriminator(),
                      torch.Generator().manual_seed(0))
    with torch.no_grad():  # scales away from 1, so g is really read
        for name, p in mpd.named_parameters():
            if name.endswith("scale"):
                p.uniform_(0.5, 1.5, generator=torch.Generator()
                           .manual_seed(len(name)))
    return mpd, reference_state_dict("mpd", mpd)


def test_mpd_scores_and_feature_maps_match_jax():
    rng = np.random.default_rng(1)
    target, pred = (0.3 * rng.standard_normal((2, T))).astype(np.float32), \
        (0.3 * rng.standard_normal((2, T))).astype(np.float32)
    jmpd = JaxMPD()
    params = fill_params(param_shapes(jmpd, target, pred), 2)
    want = jax.jit(lambda p, t, g: jmpd.apply({"params": p}, t, g))(
        params, jnp.asarray(target), jnp.asarray(pred))
    port = load_port(MultiPeriodDiscriminator(), params, "mpd")
    with torch.no_grad():
        got = port(torch.from_numpy(target), torch.from_numpy(pred))
    names = ("real score", "gen score", "real fmap", "gen fmap")
    for what, g_list, w_list in zip(names, got, want):
        assert len(g_list) == 5
        for p, g, w in zip((2, 3, 5, 7, 11), g_list, w_list):
            if "score" in what:
                assert_close(g, w, what=f"{what} period {p}")
                continue
            assert len(g) == len(w) == 5  # the first conv's map skipped
            for i, (gi, wi) in enumerate(zip(g, w)):
                assert_close(gi, wi, what=f"{what} period {p} map {i}")


def test_convert_mpd_is_bit_equal_to_jax(seeded_mpd):
    mpd, sd = seeded_mpd
    assert torch_convert.converter("mpd") is torch_convert.convert_mpd
    got, got_stats = torch_convert.convert_module("mpd", sd)
    want, want_stats = jconvert.convert_module("mpd", sd)
    assert got_stats == want_stats == {}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), k


def test_import_torch_mpd_round_trips(seeded_mpd, tmp_path, capsys):
    mpd, sd = seeded_mpd
    path = tmp_path / "pytorch_model_5.bin"
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}, path)
    (tmp_path / "model.json").write_text("{}")
    main(["import-torch", "--checkpoint", str(path), "--model-config",
          str(tmp_path / "model.json"), "--out", str(tmp_path / "out"),
          "--model", "mpd", "--device", "cpu"])
    assert f"wrote {tmp_path / 'out'}" in capsys.readouterr().out
    module = load_converted_module(tmp_path / "out" / "mpd.safetensors",
                                   "mpd", MultiPeriodDiscriminator())
    want = mpd.state_dict()
    for k, t in module.state_dict().items():
        assert torch.equal(t, want[k]), k
