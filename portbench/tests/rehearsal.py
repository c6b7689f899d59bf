"""A cell's run on the CPU at a tiny size, for the tests: the look for a
card is skipped, the CUDA calls a run makes are stubbed, the program's
kernel wrappers take their plain paths and nothing is built."""

from __future__ import annotations

import contextlib
import dataclasses
import time
from unittest import mock

import torch

from portbench import registry

TINY_TRAIN = {"batch": 2, "frames": 64, "pool": 4, "check_steps": 3,
              "warm_steps": 1, "trace_steps": 1}
TINY_SYNTH = {"batch": 2, "phonemes": [4, 12], "cycle": 3,
              "warm_batches": 1, "check_batches": 2, "trace_batches": 1}


def tiny_cell(name: str, root=registry.ROOT):
    from stylish_tts_tpu_torch.utils.synthetic import tiny_model_config

    cell = registry.cell(name, root)
    mc = tiny_model_config()
    mc.slm.layers = 1
    if cell.config["model"]["generator"]["type"] == "ringformer":
        from stylish_tts_tpu_torch.config import RingformerGeneratorConfig
        mc.generator = RingformerGeneratorConfig(
            upsample_initial_channel=16, upsample_last_channel=8)
    cell.config = dict(cell.config, model=dataclasses.asdict(mc))
    tiny = TINY_TRAIN if cell.traffic["kind"] == "train" else dict(
        TINY_SYNTH, batch=min(TINY_SYNTH["batch"], cell.traffic["batch"]))
    cell.traffic = dict(cell.traffic, **tiny)
    return cell


@contextlib.contextmanager
def on_cpu():
    from stylish_tts_tpu_torch.ops import build

    with contextlib.ExitStack() as stack:
        for name, value in (("synchronize", lambda *a, **k: None),
                            ("reset_peak_memory_stats", lambda *a: None),
                            ("memory_stats", lambda *a: {}),
                            ("max_memory_allocated", lambda *a: 0),
                            ("empty_cache", lambda: None)):
            stack.enter_context(mock.patch.object(torch.cuda, name, value))
        stack.enter_context(mock.patch.object(
            torch.Tensor, "pin_memory", lambda self, *a, **k: self))
        stack.enter_context(mock.patch.object(build, "build",
                                              lambda stems: None))
        yield


def run(name: str, seed: int = 2**31 + 7, seconds: float = 0.2,
        trace: bool = False, cell=None):
    """The output of one tiny run of cell ``name``."""
    cell = cell or tiny_cell(name)
    kind = registry.kind(cell)
    with on_cpu():
        return cell, kind.run(cell, seed, seconds, trace,
                                torch.device("cpu"), time.perf_counter())
