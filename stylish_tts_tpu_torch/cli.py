"""Command line of the port.

    python -m stylish_tts_tpu_torch.cli speak --artifact DIR \\
        --phonemes "ðɪs ɪz ə tˈɛst" --out out.wav [--device cpu]

    python -m stylish_tts_tpu_torch.cli convert --checkpoint DIR --out DIR

``speak`` synthesizes IPA phonemes from an inference artifact (see
``export/package.py``) into a 16-bit mono WAV file.  Text and book input
need the G2P front end, which is not ported yet.  ``convert`` packages the
inference artifact of a training checkpoint (``train/checkpoint.py``); it
reads both configs from the checkpoint's ``meta.json``.
"""

from __future__ import annotations

import argparse
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


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(prog="stylish_tts_tpu_torch.cli")
    sub = parser.add_subparsers(dest="command", required=True)
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
    if args.command == "convert":
        out = package_inference_artifact(args.checkpoint, args.out)
        print(f"wrote {out}")
        return
    seconds = speak(args.artifact, args.phonemes, args.out, args.device)
    print(f"wrote {args.out} ({seconds:.2f}s)")


if __name__ == "__main__":
    main()
