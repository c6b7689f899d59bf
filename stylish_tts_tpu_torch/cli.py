"""Command line of the port.

    python -m stylish_tts_tpu_torch.cli prepare-book --audio CH1.wav \\
        [--audio CH2.wav ...] --text BOOK.txt --out DATA \\
        [--transcript CH1.txt ...] [--sample-rate 24000] [--seed 0]

    python -m stylish_tts_tpu_torch.cli pitch --config CONFIG.json \\
        [--model-config MODEL.json] [--method yin] [--device cpu]

    python -m stylish_tts_tpu_torch.cli train-align --config CONFIG.json \\
        --out DIR [--model-config MODEL.json] [--checkpoint DIR] \\
        [--max-steps N] [--workers 8] [--device cpu]

    python -m stylish_tts_tpu_torch.cli align --config CONFIG.json \\
        [--model-config MODEL.json] [--device cpu]

    python -m stylish_tts_tpu_torch.cli train --config CONFIG.json \\
        --out DIR [--model-config MODEL.json] [--stage acoustic] \\
        [--checkpoint DIR] [--init-torch DIR] [--max-steps N] \\
        [--reset-stage] [--workers 8] [--device cpu]

    python -m stylish_tts_tpu_torch.cli convert --checkpoint DIR --out DIR

    python -m stylish_tts_tpu_torch.cli import-torch --checkpoint DIR \\
        --out DIR [--model-config MODEL.json] [--model NAME] [--device cpu]

    python -m stylish_tts_tpu_torch.cli test [--model-config MODEL.json] \\
        [--frames 200] [--tokens 100] [--iters 10] [--device cpu]

    python -m stylish_tts_tpu_torch.cli speak --artifact DIR \\
        (--text FILE | --book FILE.md | --phonemes "ðɪs ɪz ə tˈɛst") \\
        --out OUT [--device cpu]

The workflow from a book's audio and text to a voice: ``prepare-book``
cuts the chapters' WAVs into segments at their silences and matches each
to the book's words (``dataprep/book.py``), writing ``wav24/`` and the
train and val lists; ``pitch`` caches each segment's F0 (YIN,
``dataprep/pitch.py``); ``train-align`` trains the CTC aligner
(the ``alignment`` stage) and writes ``DIR/alignment_model.safetensors``,
which ``align`` expects in the dataset's directory
(``dataset.alignment_model_path``) to cache each segment's durations
(``dataprep/align_text.py``); ``train`` runs the four-stage chain acoustic
-> textual -> style -> duration from ``--stage`` (``train/loop.py``), or the
``joint`` stage alone, each stage's checkpoints in ``DIR/<stage>/``;
``--init-torch`` starts it from a torch reference checkpoint (an
``accelerator.save_state`` directory, ``train/torch_seed.py``) and
``slm.weights_path`` in the model config gives the SLM converted WavLM
weights; ``convert`` packages the
inference artifact of a training checkpoint (``train/checkpoint.py``),
reading both configs from its ``meta.json``; ``speak`` synthesizes into a
16-bit mono WAV file: ``--text`` normalises a text file, splits it into
sentences and reads them through the G2P front end (``textfrontend/``)
as one long-form utterance, ``--book`` writes one
``chapter-NNN.wav`` a markdown chapter into the directory ``OUT``, and
``--phonemes`` takes IPA as it is.  ``import-torch`` converts a torch
reference checkpoint into an artifact ``speak`` reads
(``export/import_torch.py``), or with ``--model`` one module's state-dict
file into ``DIR/<model>.safetensors``, and loads what it wrote into the
port's models on ``--device``; ``test`` prints the parameter table of the
models the port builds and times a speech-predictor forward on random
inputs.

Every command but ``prepare-book`` and ``convert`` runs on the card unless
``--device`` names another; configs are JSON (YAML where PyYAML imports),
the model config defaults to the full-width ``ModelConfig``.  The G2P
front end uses ``espeak-ng`` where it is on the path and its own lexicon
and rules otherwise.
"""

from __future__ import annotations

import argparse
import json
import logging
import wave
from pathlib import Path
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


def _synthesizer(artifact: str, device: Optional[str]) -> Synthesizer:
    mc, models = load_inference_models(artifact, device)
    return Synthesizer(mc, models, device=device)


def speak(artifact: str, phonemes: str, out: str,
          device: Optional[str] = None) -> float:
    """Synthesize ``phonemes`` into ``out``; returns the audio seconds."""
    synth = _synthesizer(artifact, device)
    audio = synth.synthesize(phonemes)
    write_wav(out, audio, synth.mc.sample_rate)
    return audio.shape[0] / synth.mc.sample_rate


def text_to_phonemes(text: str, g2p) -> List[str]:
    """A text's sentences as IPA: normalised, split, read by ``g2p``."""
    from .textfrontend import normalize_text, split_sentences

    return [g2p(s) for s in split_sentences(normalize_text(text))]


def speak_text(artifact: str, text_path: str, out: str,
               device: Optional[str] = None) -> float:
    """Synthesize a text file's sentences as one long-form utterance into
    ``out``; returns the audio seconds."""
    from .textfrontend import G2P

    synth = _synthesizer(artifact, device)
    text = Path(text_path).read_text(encoding="utf-8")
    audio = synth.synthesize_longform(text_to_phonemes(text, G2P()))
    write_wav(out, audio, synth.mc.sample_rate)
    return audio.shape[0] / synth.mc.sample_rate


def speak_book(artifact: str, book_path: str, out_dir: str,
               device: Optional[str] = None, pause_ms: float = 120.0
               ) -> List[tuple]:
    """One WAV a chapter of a markdown book, ``chapter-NNN.wav`` in
    ``out_dir``, ``pause_ms`` of silence between sentences; returns (path,
    seconds, title) for each."""
    from .dataprep.book import split_markdown_chapters
    from .textfrontend import G2P

    synth = _synthesizer(artifact, device)
    sample_rate = synth.mc.sample_rate
    g2p = G2P()
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    chapters = split_markdown_chapters(Path(book_path).read_text("utf-8"))
    for i, (title, body) in enumerate(chapters, 1):
        audio = synth.synthesize_longform(text_to_phonemes(body, g2p),
                                          silence_ms=pause_ms)
        path = out / f"chapter-{i:03d}.wav"
        write_wav(str(path), audio, sample_rate)
        written.append((path, audio.shape[0] / sample_rate, title))
    return written


def _model_config(path: Optional[str]):
    from .config import ModelConfig, load_config_file

    return load_config_file(path, ModelConfig) if path else ModelConfig()


def _configs(args: argparse.Namespace):
    from .config import load_config_file

    return load_config_file(args.config), _model_config(args.model_config)


def train(args: argparse.Namespace, stage: Optional[str] = None) -> None:
    from .train.loop import train_model
    from .train.stages import check_stage

    stage = stage or args.stage
    check_stage(stage)
    config, model_config = _configs(args)
    manifest = train_model(
        config=config, model_config=model_config, out_dir=args.out,
        stage_name=stage, checkpoint=args.checkpoint,
        init_torch=getattr(args, "init_torch", None),
        max_steps=args.max_steps,
        reset_stage=getattr(args, "reset_stage", False),
        workers=args.workers, device=args.device)
    print(f"trained to {manifest.stage} step {manifest.current_total_step} "
          f"({manifest.total_trained_audio_seconds:.1f} s of audio); "
          f"checkpoints in {args.out}")


def import_torch(args: argparse.Namespace) -> Path:
    """Convert the reference checkpoint, then load what was written into
    the port's models on ``args.device``."""
    from .export.import_torch import (import_torch_checkpoint,
                                      load_converted_module)
    from .train.init import build_training_models

    mc = _model_config(args.model_config)
    out = import_torch_checkpoint(args.checkpoint, args.out, mc,
                                  single_model=args.model)
    if args.model is None:
        load_inference_models(out, args.device)
    else:
        from .device import resolve_device

        module = build_training_models(mc)[args.model]
        load_converted_module(out / f"{args.model}.safetensors", args.model,
                              module).to(resolve_device(args.device))
    return out


def time_models(args: argparse.Namespace) -> tuple:
    """The parameter table of the models the port builds (drawn from seed
    0), then the mean wall seconds of a speech-predictor inference forward
    at batch 2 on ``args.tokens`` zero tokens and ``args.frames`` frames;
    returns (table, seconds, audio seconds of one batch)."""
    import torch

    from .device import resolve_device
    from .export.import_torch import REFERENCE_SAVE_ORDER
    from .train.init import build_training_models, init_params
    from .utils.harness import param_table, time_forward

    device = resolve_device(args.device)
    mc = _model_config(args.model_config)
    built = build_training_models(mc)
    generator = torch.Generator().manual_seed(0)
    models = {k: init_params(built[k], generator)
              for k in REFERENCE_SAVE_ORDER if k in built}
    table = param_table(models)
    sp = models["speech_predictor"].to(device).eval()
    b, tokens, frames = 2, args.tokens, args.frames
    tok = torch.zeros(b, tokens, dtype=torch.long, device=device)
    lengths = torch.full((b,), tokens, dtype=torch.long, device=device)
    align = torch.zeros(b, tokens, frames, device=device)
    align[:, 0] = 1.0
    pitch = torch.full((b, frames), 120.0, device=device)
    energy = torch.ones(b, frames, device=device)
    sample = torch.Generator(device=device).manual_seed(1)

    @torch.no_grad()
    def forward():
        return sp(tok, lengths, align, pitch, energy, None,
                  generator=sample).audio

    seconds = time_forward(forward, (), args.iters, device)
    return table, seconds, b * frames * mc.hop_length / mc.sample_rate


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")


def _add_configs(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", required=True, help="run config (JSON)")
    p.add_argument("--model-config", default=None,
                   help="model config (JSON; default: the full-width one)")


def _add_run(p: argparse.ArgumentParser) -> None:
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint directory to resume or start from")
    p.add_argument("--max-steps", type=int, default=None,
                   help="stop after this many steps in all")
    p.add_argument("--workers", type=int, default=8,
                   help="data-loader threads")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="stylish_tts_tpu_torch.cli",
        description="prepare-book -> pitch -> train-align -> align -> "
                    "train -> convert -> speak; import-torch, test")
    sub = parser.add_subparsers(dest="command", required=True)
    bp = sub.add_parser("prepare-book",
                        help="a book's chapter WAVs and text -> a dataset")
    bp.add_argument("--audio", action="append", required=True,
                    help="chapter WAV file, in book order (repeatable)")
    bp.add_argument("--text", required=True, help="the book's text")
    bp.add_argument("--out", required=True, help="dataset directory")
    bp.add_argument("--transcript", action="append", default=[],
                    help="per-chapter ASR phrase list "
                         "(phrase|start|end|text), one per --audio")
    bp.add_argument("--sample-rate", type=int, default=24000)
    bp.add_argument("--seed", type=int, default=0)
    pp = sub.add_parser("pitch", help="cache the dataset's F0 (YIN)")
    _add_configs(pp)
    pp.add_argument("--method", default="yin", choices=("yin", "rmvpe"),
                    help="rmvpe is not ported yet")
    _add_device(pp)
    ap = sub.add_parser("train-align", help="train the CTC aligner")
    _add_configs(ap)
    _add_run(ap)
    _add_device(ap)
    lp = sub.add_parser("align", help="cache the dataset's alignments")
    _add_configs(lp)
    _add_device(lp)
    tp = sub.add_parser("train", help="train the four-stage chain, or "
                                      "the joint stage")
    _add_configs(tp)
    _add_run(tp)
    tp.add_argument("--stage", default="acoustic",
                    help="first stage of the chain (default: acoustic), "
                         "or joint")
    tp.add_argument("--reset-stage", action="store_true",
                    help="restart the stage's step and epoch counters "
                         "after loading the checkpoint")
    tp.add_argument("--init-torch", default=None,
                    help="seed the models from a torch reference "
                         "checkpoint directory before training")
    _add_device(tp)
    cp = sub.add_parser("convert",
                        help="package a checkpoint as an inference artifact")
    cp.add_argument("--checkpoint", required=True,
                    help="training checkpoint directory")
    cp.add_argument("--out", required=True, help="artifact directory")
    ip = sub.add_parser("import-torch",
                        help="a torch reference checkpoint -> an artifact")
    ip.add_argument("--checkpoint", required=True,
                    help="reference accelerator save_state directory (or "
                         "one state-dict file with --model)")
    ip.add_argument("--model-config", default=None,
                    help="model config (JSON; default: the full-width one)")
    ip.add_argument("--out", required=True, help="artifact directory")
    ip.add_argument("--model", default=None,
                    help="convert just this module from one state-dict file")
    _add_device(ip)
    xp = sub.add_parser("test", help="parameter table and a timed forward")
    xp.add_argument("--model-config", default=None,
                    help="model config (JSON; default: the full-width one)")
    xp.add_argument("--frames", type=int, default=200)
    xp.add_argument("--tokens", type=int, default=100)
    xp.add_argument("--iters", type=int, default=10)
    _add_device(xp)
    sp = sub.add_parser("speak", help="synthesize text, a book or phonemes")
    sp.add_argument("--artifact", required=True,
                    help="inference artifact directory")
    given = sp.add_mutually_exclusive_group(required=True)
    given.add_argument("--text", help="text file, read sentence by sentence")
    given.add_argument("--book", help="markdown book: one WAV a chapter "
                                      "into --out, a directory")
    given.add_argument("--phonemes", help="IPA phoneme input")
    sp.add_argument("--out", required=True,
                    help="output WAV path (a directory with --book)")
    _add_device(sp)
    return parser


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    if args.command in ("train", "train-align", "pitch", "align"):
        logging.basicConfig(
            level=logging.INFO,
            format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    if args.command == "train":
        train(args)
    elif args.command == "train-align":
        train(args, stage="alignment")
    elif args.command == "convert":
        out = package_inference_artifact(args.checkpoint, args.out)
        print(f"wrote {out}")
    elif args.command == "import-torch":
        print(f"wrote {import_torch(args)}")
    elif args.command == "test":
        table, seconds, audio_s = time_models(args)
        print(table)
        print(f"speech_predictor forward: {seconds * 1000:.1f} ms/batch "
              f"({audio_s / seconds:.1f}x realtime)")
    elif args.command == "prepare-book":
        from .dataprep.book import prepare_book

        if args.transcript and len(args.transcript) != len(args.audio):
            raise SystemExit("--transcript count must match --audio count")
        stats = prepare_book(
            audio_files=args.audio, book_text_file=args.text,
            out_dir=args.out, sample_rate=args.sample_rate,
            transcripts=args.transcript or None, seed=args.seed)
        print(json.dumps(stats))
    elif args.command == "pitch":
        from .dataprep.pitch import calculate_pitch

        config, model_config = _configs(args)
        out = calculate_pitch(config, model_config, method=args.method,
                              device=args.device)
        print(f"wrote {config.dataset.pitch_path} ({len(out)} segments)")
    elif args.command == "align":
        from .dataprep.align_text import align_text

        config, model_config = _configs(args)
        out = align_text(config, model_config, device=args.device)
        print(f"wrote {config.dataset.alignment_path} ({len(out)} segments)")
    elif args.book:
        for path, seconds, title in speak_book(args.artifact, args.book,
                                               args.out, args.device):
            print(f"{path} ({seconds:.2f}s) {title}")
    else:
        seconds = (speak(args.artifact, args.phonemes, args.out, args.device)
                   if args.phonemes is not None else
                   speak_text(args.artifact, args.text, args.out,
                              args.device))
        print(f"wrote {args.out} ({seconds:.2f}s)")


if __name__ == "__main__":
    main()
