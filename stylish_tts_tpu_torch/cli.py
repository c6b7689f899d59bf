"""Command line of the port.

    python -m stylish_tts_tpu_torch.cli train --config CONFIG.json \\
        --out DIR [--model-config MODEL.json] [--stage acoustic] \\
        [--checkpoint DIR] [--max-steps N] [--reset-stage] [--workers 8] \\
        [--device cpu]

    python -m stylish_tts_tpu_torch.cli speak --artifact DIR \\
        --phonemes "ðɪs ɪz ə tˈɛst" --out out.wav [--device cpu]

    python -m stylish_tts_tpu_torch.cli convert --checkpoint DIR --out DIR

``train`` runs the four-stage chain acoustic -> textual -> style ->
duration from ``--stage`` (``train/loop.py``) on the card unless
``--device`` names another; configs are JSON (YAML where PyYAML imports),
the model config defaults to the full-width ``ModelConfig``.  Each
stage's checkpoints land in ``DIR/<stage>/``.  ``speak`` synthesizes IPA
phonemes from an inference artifact (see ``export/package.py``) into a
16-bit mono WAV file.  Text and book input need the G2P front end, which
is not ported yet.  ``convert`` packages the inference artifact of a
training checkpoint (``train/checkpoint.py``); it reads both configs from
the checkpoint's ``meta.json``.
"""

from __future__ import annotations

import argparse
import logging
import wave
from typing import List, Optional

import numpy as np

from .export.infer import Synthesizer
from .export.package import load_inference_models, package_inference_artifact


def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    pcm = (np.clip(audio, -1, 1) * 32767).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


def speak(artifact: str, phonemes: str, out: str,
          device: Optional[str] = None) -> float:
    """Synthesize ``phonemes`` into ``out``; returns the audio seconds."""
    mc, models = load_inference_models(artifact, device)
    synth = Synthesizer(mc, models, device=device)
    audio = synth.synthesize(phonemes)
    write_wav(out, audio, mc.sample_rate)
    return audio.shape[0] / mc.sample_rate


def train(args: argparse.Namespace) -> None:
    from .config import ModelConfig, load_config_file
    from .train.loop import train_model
    from .train.stages import check_stage

    check_stage(args.stage)
    config = load_config_file(args.config)
    model_config = (load_config_file(args.model_config, ModelConfig)
                    if args.model_config else ModelConfig())
    manifest = train_model(
        config=config, model_config=model_config, out_dir=args.out,
        stage_name=args.stage, checkpoint=args.checkpoint,
        max_steps=args.max_steps, reset_stage=args.reset_stage,
        workers=args.workers, device=args.device)
    print(f"trained to {manifest.stage} step {manifest.current_total_step} "
          f"({manifest.total_trained_audio_seconds:.1f} s of audio); "
          f"checkpoints in {args.out}")


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(prog="stylish_tts_tpu_torch.cli")
    sub = parser.add_subparsers(dest="command", required=True)
    tp = sub.add_parser("train", help="train the four-stage chain")
    tp.add_argument("--config", required=True, help="run config (JSON)")
    tp.add_argument("--model-config", default=None,
                    help="model config (JSON; default: the full-width one)")
    tp.add_argument("--out", required=True, help="output directory")
    tp.add_argument("--stage", default="acoustic",
                    help="first stage of the chain (default: acoustic)")
    tp.add_argument("--checkpoint", default=None,
                    help="checkpoint directory to resume or start from")
    tp.add_argument("--max-steps", type=int, default=None,
                    help="stop after this many steps in all")
    tp.add_argument("--reset-stage", action="store_true",
                    help="restart the stage's step and epoch counters "
                         "after loading the checkpoint")
    tp.add_argument("--workers", type=int, default=8,
                    help="data-loader threads")
    tp.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    sp = sub.add_parser("speak", help="synthesize phonemes to a WAV file")
    sp.add_argument("--artifact", required=True,
                    help="inference artifact directory")
    sp.add_argument("--phonemes", required=True, help="IPA phoneme input")
    sp.add_argument("--out", required=True, help="output WAV path")
    sp.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    cp = sub.add_parser("convert",
                        help="package a checkpoint as an inference artifact")
    cp.add_argument("--checkpoint", required=True,
                    help="training checkpoint directory")
    cp.add_argument("--out", required=True, help="artifact directory")
    args = parser.parse_args(argv)
    if args.command == "train":
        logging.basicConfig(
            level=logging.INFO,
            format="%(asctime)s %(levelname)s %(name)s: %(message)s")
        train(args)
        return
    if args.command == "convert":
        out = package_inference_artifact(args.checkpoint, args.out)
        print(f"wrote {out}")
        return
    seconds = speak(args.artifact, args.phonemes, args.out, args.device)
    print(f"wrote {args.out} ({seconds:.2f}s)")


if __name__ == "__main__":
    main()
