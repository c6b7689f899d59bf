"""The patch-staging probes: the TPU probe script's Pallas kernels (in
interpret mode) against the port's wrappers on CPU tensors (their plain
versions), and the port's probe entry point on the CPU."""

from __future__ import annotations

import functools
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from stylish_tts_tpu_torch.ops import patch_probe as pp
from stylish_tts_tpu_torch.scripts import mosaic_probe as port_probe

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_probe():
    """``scripts/mosaic_probe.py``, loaded by path (scripts/ is no
    package)."""
    spec = importlib.util.spec_from_file_location(
        "mosaic_probe_tpu", ROOT / "scripts" / "mosaic_probe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def interpret(monkeypatch):
    """Every pallas_call in interpret mode; its outputs are recorded."""
    outputs = []
    orig = pl.pallas_call

    def recording(*args, **kwargs):
        call = functools.partial(orig, interpret=True)(*args, **kwargs)

        def run(*operands):
            out = call(*operands)
            outputs.append(np.asarray(out))
            return out

        return run

    monkeypatch.setattr(pl, "pallas_call", recording)
    return outputs


def probe_input() -> np.ndarray:
    return np.random.default_rng(0).standard_normal((262, 32)).astype(
        np.float32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))  # a writable copy


COPIES = {
    "concat_full_lane": pp.concat_full_lane,
    "scratch_write": pp.scratch_write,
    "stack_reshape": pp.stack_reshape,
    "dma_assemble": pp.dma_assemble,
}


def _matches_jax(jax_probe, name: str, xh: np.ndarray) -> None:
    """The TPU probe ``name`` against the port's wrapper on x = ``xh``."""
    fn = getattr(jax_probe, f"probe_{name}")
    if name in COPIES or name == "concat_lane_off":
        want = np.asarray(fn(jnp.asarray(xh)))
        if name == "concat_lane_off":
            got = pp.concat_lane_off(_t(np.concatenate([xh, xh * 2.0], 1)))
        else:
            got = COPIES[name](_t(xh))
        assert got.shape == want.shape == (len(xh) - 6, 192)
        np.testing.assert_array_equal(got.numpy(), want)  # moves data only
        return
    y, w = fn(jnp.asarray(xh))
    want = np.asarray(y)
    got = getattr(pp, name)(_t(xh), _t(np.asarray(w))).numpy()
    assert got.shape == want.shape == (len(xh) - 6, 128)
    # f32 sums of 192 products in another order
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


@pytest.mark.parametrize("name", port_probe.PROBES)
def test_probe_matches_jax(jax_probe, interpret, name):
    xh = probe_input()
    if name != "mini_kernel":
        _matches_jax(jax_probe, name, xh)
        return
    assert jax_probe.probe_mini_kernel(jnp.asarray(xh)) == "ok"
    (want,) = interpret
    rng = np.random.default_rng(1)
    xq = rng.standard_normal((2, 5, 520, 128)).astype(np.float32)
    w = rng.standard_normal((1728, 128)).astype(np.float32) * 0.1
    got = pp.mini_kernel(_t(xq), _t(w)).numpy()
    assert got.shape == want.shape
    # f32 sums of 1728 products in another order
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


# The TPU probes read their row count from the script's module-level T, so
# they also run at the card tests' other row counts.
@pytest.mark.parametrize("rows", [32, 96, 160])
@pytest.mark.parametrize("name", [n for n in port_probe.PROBES
                                  if n != "mini_kernel"])
def test_probe_matches_jax_at_other_row_counts(jax_probe, interpret,
                                               monkeypatch, name, rows):
    monkeypatch.setattr(jax_probe, "T", rows)
    _matches_jax(jax_probe, name, np.random.default_rng(rows).standard_normal(
        (rows + 6, 32)).astype(np.float32))


def test_entry_point_on_cpu(jax_probe, capsys):
    assert port_probe.main(["--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert list(report) == jax_probe.PROBES
    assert set(report.values()) == {"ok"}


def test_entry_point_reports_a_failure_with_exit_code_1(monkeypatch, capsys):
    monkeypatch.setattr(pp, "scratch_write", lambda x: torch.zeros(256, 192))

    def broken(x):
        raise RuntimeError("no kernel")

    monkeypatch.setattr(pp, "dma_assemble", broken)
    assert port_probe.main(["--device", "cpu", "--probe",
                            "concat_full_lane,scratch_write,dma_assemble"]
                           ) == 1
    report = json.loads(capsys.readouterr().out)
    assert report == {"concat_full_lane": "ok",
                      "scratch_write": "WRONG_NUMERICS",
                      "dma_assemble": "FAIL: no kernel"}


def test_entry_point_without_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_probe.main(["--probe", "concat_full_lane"])


def test_wrappers_on_cpu_take_the_plain_path():
    x = _t(probe_input())
    w = port_probe.product_weights("cpu")
    xq, wq = (_t(a) for a in port_probe.mini_inputs())
    xq = xq[:, :, :72]  # R = 64
    before = [k.launches for k in pp.KERNELS]
    want = pp.patches_plain(x)
    for k in (pp.concat_full_lane, pp.scratch_write, pp.stack_reshape,
              pp.dma_assemble):
        assert torch.equal(k(x), want)
    xp = torch.cat([x, 2 * x], dim=1)
    assert torch.equal(pp.concat_lane_off(xp), pp.lane_off_plain(xp))
    for k in (pp.matmul_after_concat, pp.matmul_after_scratch):
        assert torch.equal(k(x, w), pp.matmul_plain(x, w))
    assert torch.equal(pp.mini_kernel(xq, wq), pp.mini_plain(xq, wq))
    assert [k.launches for k in pp.KERNELS] == before == [0] * 8
