"""Synthetic sine-speech dataset for smoke runs and tests.

Writes the full on-disk layout the trainer reads (``wav24/``, the train
and val lists, the pitch and alignment safetensors caches, the reference's
cache format, train/dataloader.py:32-50), so the data path runs end to end
without real speech.  Layout, draws and file names equal the JAX package's
generator, so both write the same dataset for the same arguments.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from scipy.io import wavfile

from .tensorfile import write_safetensors


def make_synthetic_dataset(
    root: Path, n_segments: int = 6, seconds: float | None = None,
    spread: float = 0.3, n_val: int = 2,
) -> None:
    """Sine-speech segments with pitch and alignment caches.  Default
    utterances are 0.3-0.5 s (fast tests); ``seconds`` gives segments of
    1 - ``spread`` to 1 + ``spread`` times that length.  The last ``n_val``
    segments form the val list.  The defaults draw the JAX generator's
    dataset."""
    root = Path(root)
    sr, hop = 24000, 300
    rng = np.random.default_rng(0)
    (root / "wav24").mkdir(parents=True, exist_ok=True)
    phon_pool = list("abcdefghijklmnop")
    lines = []
    pitch_map, align_map = {}, {}
    for i in range(n_segments):
        if seconds is None:
            frames = int(rng.integers(24, 40))  # 0.3-0.5 s
        else:
            base_frames = int(seconds * sr / hop)
            frames = int(rng.integers(
                max(24, int(base_frames * (1 - spread))),
                int(base_frames * (1 + spread))
            ))
        n = frames * hop + int(rng.integers(0, hop))
        f0 = 120.0 + 40.0 * rng.random()
        t = np.arange(n) / sr
        wave = 0.4 * np.sin(2 * np.pi * f0 * t) * (
            0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t)
        ) + 0.01 * rng.standard_normal(n)
        name = f"seg_{i}.wav"
        wavfile.write(
            root / "wav24" / name, sr, (wave * 32767).astype(np.int16)
        )
        # token count tracks duration (~8 frames = 100 ms per phoneme)
        n_ph = int(np.clip(frames // 8, 4, 120))
        n_ph = int(rng.integers(max(4, n_ph - 2), n_ph + 3))
        phonemes = "".join(rng.choice(phon_pool, n_ph))
        lines.append(f"{name}|{phonemes}|0|{phonemes}")
        n_frames = n // hop + 1
        pitch_map[name] = np.full(n_frames, f0, np.float32)
        # alignment over the bracketed text (n_ph + 2 pads), filling the
        # bin's padded frame count ((n // hop - 20) // 20 * 20 + 60)
        tokens = n_ph + 2
        bin_num = (n // hop - 20) // 20
        frame_count = bin_num * 20 + 60
        base = frame_count // tokens
        durs = np.full(tokens, base, np.float32)
        durs[-1] += frame_count - base * tokens
        align_map[name] = np.stack(
            [durs, np.full(tokens, 0.2, np.float32),
             np.full(tokens, 0.2, np.float32)]
        )
    (root / "train-list.txt").write_text("\n".join(lines[:-n_val]))
    (root / "val-list.txt").write_text("\n".join(lines[-n_val:]))
    write_safetensors(root / "pitch.safetensors", pitch_map)
    write_safetensors(root / "alignment.safetensors", align_map)


def tiny_model_config():
    """The JAX package's down-scaled ModelConfig for smoke tests: a
    1-layer text encoder, narrow decoder and generator, a 2-layer SLM."""
    from ..config import ModelConfig

    mc = ModelConfig()
    mc.text_encoder.layers = 1
    mc.text_encoder.hidden_dim = 64
    mc.text_encoder.filter_channels = 128
    mc.text_encoder.heads = 4
    mc.inter_dim = 64
    mc.style_dim = 32
    mc.decoder.hidden_dim = 128
    mc.decoder.residual_dim = 32
    mc.generator.input_dim = 128
    mc.generator.hidden_dim = 128
    mc.generator.conv_intermediate_dim = 256
    mc.slm.layers = 2
    mc.text_aligner.hidden_dim = 64
    return mc
