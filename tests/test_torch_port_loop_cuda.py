"""The measured memory plan on the card at the tiny config: the probe
solves sizes of at least 1 for every bin and leaves the train state as it
found it, every tensor ``torch.equal`` and no moment created.

Imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_port_loop_cuda.py

Without a card every test skips.
"""

from __future__ import annotations

import pytest
import torch

from stylish_tts_tpu_torch.config import Config, ModelConfig
from stylish_tts_tpu_torch.data.batch_manager import (BatchManager,
                                                      probe_batch_arrays,
                                                      step_memory)
from stylish_tts_tpu_torch.data.dataset import (FilePathDataset,
                                                get_data_path_list)
from stylish_tts_tpu_torch.text import TextCleaner
from stylish_tts_tpu_torch.train.init import build_train_state, init_slm
from stylish_tts_tpu_torch.train.stages import (STAGES, StageContext,
                                                chain_models, make_train_step)
from stylish_tts_tpu_torch.train.state import snapshot_state
from stylish_tts_tpu_torch.utils.synthetic import (make_synthetic_dataset,
                                                   tiny_model_config)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the probe measures its memory")


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return a == b


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["acoustic", "style"])
def test_memory_probe_on_the_card(cuda, tmp_path, stage):
    make_synthetic_dataset(tmp_path / "data", n_segments=14, seconds=1.0)
    mc = tiny_model_config()
    mc.slm.layers = 1
    data = tmp_path / "data"
    dataset = FilePathDataset(
        data_list=get_data_path_list(data / "train-list.txt"),
        root_path=data / "wav24", text_cleaner=TextCleaner(),
        model_config=ModelConfig(), pitch_path=str(data / "pitch.safetensors"),
        alignment_path=str(data / "alignment.safetensors"))
    manager = BatchManager(dataset, tmp_path / "out", stage,
                           probe_batch_max=2)
    assert manager.freshly_planned and len(manager.time_bins) >= 2
    state = build_train_state(mc, chain_models("acoustic"), device="cuda",
                              generator=torch.Generator().manual_seed(0))
    ctx = StageContext(
        model_config=mc, config=Config(), mel_mean=-4.0, mel_std=4.0,
        step_limit=100,
        slm=init_slm(mc, torch.Generator().manual_seed(1)).to("cuda"),
        duration_class_weight=torch.ones(16, device="cuda"))
    step = make_train_step(stage, ctx, 1e-4)
    # a state that has stepped before: the stage's moments exist, the
    # other models' do not yet
    first = {k: torch.from_numpy(v).to("cuda") for k, v in
             probe_batch_arrays(mc, 2, min(manager.time_bins),
                                STAGES[stage].inputs, seed=1).items()}
    step(state, first, torch.Generator(device="cuda").manual_seed(2))
    before = snapshot_state(state)
    fit = manager.refine_plan(
        step_memory(step, state, mc, STAGES[stage].inputs, "cuda"),
        budget_bytes=4 * 2**30, probe_batch=2)
    assert fit["kept"] is None and fit["per_sample_frame"] > 0
    assert all(b >= 1 for b in manager.batch_sizes.values())
    assert set(manager.batch_sizes) == {str(b) for b in manager.time_bins}
    after = snapshot_state(state)
    for key in ("models", "optimizers", "disc_ema", "step"):
        assert _same(after[key], before[key]), key
    assert all(p.grad is None for m in state.models.values()
               for p in m.parameters())
