"""On the card, at each cell's own size: the control (the reference in the
precision below the configuration's, ``portbench/control.py``) fails one of
the cell's limits, and the program passes them all.  Skips without a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        portbench/tests/test_portbench_control_cuda.py
"""

import pytest
import torch

from portbench import control, registry

SEED = 4_294_967_311


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  registry.benchmark()["workloads"]])
def test_control_fails_and_program_passes(card, name):
    cell = registry.cell(name)
    if cell.traffic["kind"] == "train":
        got = control.train_readings(cell, SEED, card)
    else:
        got = control.synth_readings(cell, SEED, card, 8.0)
    limits = cell.limits
    assert all(got["program"][k] <= v for k, v in limits.items()), got
    assert any(got["control"][k] > v for k, v in limits.items()), got
    if "wgrad_x2" in got:
        assert got["wgrad_x2"]["norm_gap.mrd"] > limits["norm_gap.mrd"], got
