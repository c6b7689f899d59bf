"""CLI ``train`` of the port on the CPU, end to end: a synthetic dataset on
disk, all four stages of the chain (one step each) at a tiny
config written as JSON, then ``convert`` of the last checkpoint and
``speak`` from the artifact, which writes a WAV of the expected length.
"""

from __future__ import annotations

import json
import wave

import pytest
import torch

from stylish_tts_tpu_torch.cli import main
from stylish_tts_tpu_torch.config import Config, dump_json
from stylish_tts_tpu_torch.utils.synthetic import (make_synthetic_dataset,
                                                   tiny_model_config)

STAGES = ("acoustic", "textual", "style", "duration")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads while the module runs: the suite runs test
    files in parallel workers, and torch's default of one thread a core
    in each of them oversubscribes the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_train")
    make_synthetic_dataset(root / "data", n_segments=6)
    mc = tiny_model_config()
    mc.slm.layers = 1
    mc.mel_style_encoder.max_channels = 64
    (root / "model.json").write_text(dump_json(mc))
    cfg = Config()
    cfg.dataset.path = str(root / "data")
    for stage in STAGES:
        plan = getattr(cfg.training_plan, stage)
        plan.epochs = 1
        plan.probe_batch_max = 1  # the 4 train segments in one batch
    cfg.training.log_interval = 1
    cfg.training.val_interval = 2
    cfg.training.save_interval = 3
    (root / "config.json").write_text(dump_json(cfg))
    main(["train", "--config", str(root / "config.json"), "--model-config",
          str(root / "model.json"), "--out", str(root / "out"),
          "--device", "cpu", "--workers", "2"])
    return root, mc


def test_cli_train_runs_the_chain(trained):
    root, _ = trained
    out = root / "out"
    total = 0
    for i, stage in enumerate(STAGES):
        meta = json.loads((out / stage / "checkpoint_final" / "meta.json")
                          .read_text())
        manifest = meta["manifest"]
        assert manifest["stage"] == stage
        assert manifest["current_step"] == manifest["steps_per_epoch"] == 1
        total += manifest["current_step"]
        assert manifest["current_total_step"] == total == i + 1
        stats = json.loads((out / stage / "train_stats.json").read_text())
        assert stats["steps"] == 1 and len(stats["logs"]) == 1
        # [bin, rows, tokens, samples]
        assert stats["batches"] == [[0, 4, 64, 60 * 300]]
        assert stats["probe"] == {"kept": "no device memory to measure on "
                                          "cpu"}
        assert json.loads((out / stage / f"{stage}_batch_sizes.json")
                          .read_text()) == {"0": 4}
        # validation every 2 steps (textual, duration), a periodic save
        # every 3 (style)
        step = i + 1
        assert [v["step"] for v in stats["validations"]] == (
            [step] if step % 2 == 0 else [])
        periodic = [f"checkpoint_00001_step_{step:09d}"] if step % 3 == 0 \
            else []
        assert [s["name"] for s in stats["saves"]] == periodic + [
            "checkpoint_final"]
    assert manifest["best_loss"] < float("inf")
    assert manifest["total_trained_audio_seconds"] == pytest.approx(
        4 * 4 * 60 * 300 / 24000)


def test_cli_convert_and_speak_the_last_checkpoint(trained, capsys):
    root, mc = trained
    art, wav = root / "artifact", root / "out.wav"
    main(["convert", "--checkpoint",
          str(root / "out" / "duration" / "checkpoint_final"),
          "--out", str(art)])
    main(["speak", "--artifact", str(art), "--phonemes", "abcdefg",
          "--out", str(wav), "--device", "cpu"])
    assert f"wrote {wav}" in capsys.readouterr().out
    with wave.open(str(wav), "rb") as f:
        assert f.getframerate() == mc.sample_rate
        frames = f.getnframes()
    # whole frames of the hop, from the predicted durations of 7 + 2 tokens
    assert frames > 0 and frames % mc.hop_length == 0


def test_cli_train_names_stages_not_ported(tmp_path):
    (tmp_path / "config.json").write_text(dump_json(Config()))
    for stage, item in (("joint", "item 3"), ("cfm_hubert_mel", "item 7")):
        with pytest.raises(NotImplementedError, match=item):
            main(["train", "--config", str(tmp_path / "config.json"),
                  "--out", str(tmp_path / "out"), "--stage", stage,
                  "--device", "cpu"])
    with pytest.raises(ValueError, match="invalid stage"):
        main(["train", "--config", str(tmp_path / "config.json"),
              "--out", str(tmp_path / "out"), "--stage", "nope",
              "--device", "cpu"])


def test_config_file_reads_json_and_yaml(tmp_path):
    from stylish_tts_tpu_torch.config import ModelConfig, load_config_file

    cfg = Config()
    cfg.training.log_interval = 7
    (tmp_path / "c.json").write_text(dump_json(cfg))
    assert load_config_file(tmp_path / "c.json") == cfg
    yaml = pytest.importorskip("yaml")
    (tmp_path / "m.yml").write_text(yaml.safe_dump(
        {"style_dim": 32, "text_encoder": {"layers": 1}}))
    mc = load_config_file(tmp_path / "m.yml", ModelConfig)
    assert mc.style_dim == 32 and mc.text_encoder.layers == 1
