"""Synthetic data for smoke runs and tests: a sine-speech dataset, the
down-scaled model config, speech-like audio of known F0, and a torch
reference checkpoint written from the port's modules.

The dataset has the full on-disk layout the trainer reads (``wav24/``, the
train and val lists, the pitch and alignment safetensors caches, the
reference's cache format, train/dataloader.py:32-50), so the data path
runs end to end without real speech.  Layout, draws and file names equal
the JAX package's generator, so both write the same dataset for the same
arguments.  The reference checkpoint (``write_reference_checkpoint``)
carries a state into the torch reference's key names and layouts, so the
import path runs without a reference training run.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

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


def make_speechlike(rng: np.random.Generator, sr: int = 24000,
                    hop: int = 300, dur_s: float = 3.0,
                    f0_base: float = 140.0):
    """Speech-like audio with a known F0: harmonic stacks under three
    formants on a contour of vibrato (5.5 Hz, ±50 cents), a random walk and
    a 6% declination, with fricative (pre-emphasised noise) and silent
    stretches of 15-60 frames.  Returns (wave [n] f32, f0 [n // hop + 1],
    segments [n // hop + 1]: 1 voiced, 2 fricative, 0 silent).  The same
    draws as the JAX package's test generator, so a seed gives the same
    utterances (``scripts/pitch_eval.py``)."""
    from scipy.signal import lfilter

    n = int(dur_s * sr)
    t = np.arange(n) / sr
    n_fr = n // hop + 1
    cents = 50 * np.sin(2 * np.pi * 5.5 * np.arange(n_fr) * hop / sr)
    cents += np.cumsum(rng.standard_normal(n_fr)) * 2.0
    f0_fr = f0_base * 2.0 ** (cents / 1200.0)
    f0_fr *= 1.0 - 0.06 * np.linspace(0, 1, n_fr)
    seg = np.zeros(n_fr, np.int8)
    pos = 0
    while pos < n_fr:
        kind = rng.choice([1, 1, 1, 2, 0], p=[0.25, 0.25, 0.25, 0.15, 0.10])
        ln = int(rng.integers(15, 60))
        seg[pos : pos + ln] = kind
        pos += ln
    f0_fr = np.where(seg == 1, f0_fr, 0.0)

    f0_samp = np.repeat(f0_fr, hop)[:n]
    phase = 2 * np.pi * np.cumsum(f0_samp) / sr
    wave = np.zeros(n)
    formants = [(500, 80), (1500, 120), (2500, 180)]
    for h in range(1, 30):
        fh = f0_samp * h
        env = sum(
            np.exp(-((fh - fc) ** 2) / (2 * bw**2)) for fc, bw in formants
        )
        wave += (0.25 / h) * (0.3 + env) * np.sin(phase * h) * (fh < sr / 2)
    wave *= np.repeat(seg == 1, hop)[:n]
    wave *= 1 + 0.1 * np.sin(2 * np.pi * 3 * t)  # amplitude shimmer
    fric = lfilter([1, -0.95], [1], rng.standard_normal(n)) * 0.05
    wave = wave + fric * np.repeat(seg == 2, hop)[:n]
    wave = wave + 0.003 * rng.standard_normal(n)
    return wave.astype(np.float32), f0_fr, seg


# --------------------------------------------------------------------------- #
# a torch reference checkpoint written from the port's modules
#
# The inverse of ``models/torch_convert.py``, written from the reference
# layout the converters read: each flat flax name of a module
# (``convert.export_flax_params``) goes back to the reference's torch key
# and layout.  Weight norms are written as the reference holds them: the
# pitch/energy and decoder convs under ``parametrizations.weight.original0``
# (g) and ``original1`` (v), the flows' and posterior encoder's WaveNet
# convs under the legacy ``weight_g``/``weight_v``, v the kernel in torch
# layout and g its norm over every axis but the first; the MRD's convs as
# g = the flax ``WeightNorm`` scale and v = its kernel.  A spectral norm is
# written as ``weight_orig`` with ``weight_u`` (the flax ``u``) and
# ``weight_v`` (one power-iteration step from it).

Flat = Dict[str, np.ndarray]


def _indices(f: Flat, prefix: str) -> List[int]:
    """The sorted i of every ``<prefix><i>/...`` name of ``f``."""
    found = {int(k[len(prefix):].split("/", 1)[0]) for k in f
             if k.startswith(prefix) and k[len(prefix):].split("/", 1)[0]
             .isdigit()}
    return sorted(found)


def _put(sd: Flat, key: str, w: np.ndarray, norm: Optional[str]) -> None:
    """Write torch weight ``w`` at ``key + "weight"``, weight-normed as
    ``norm`` says ("param": parametrizations, "legacy": weight_g/v)."""
    w = np.ascontiguousarray(w, dtype=np.float32)
    if norm is None:
        sd[key + "weight"] = w
        return
    g = np.sqrt(np.sum(w.reshape(w.shape[0], -1) ** 2, axis=1)).reshape(
        (-1,) + (1,) * (w.ndim - 1)).astype(np.float32)
    if norm == "param":
        sd[key + "parametrizations.weight.original0"] = g
        sd[key + "parametrizations.weight.original1"] = w
    else:
        sd[key + "weight_g"] = g
        sd[key + "weight_v"] = w


def _conv1d(sd, f, t, k, norm=None, bias=True):
    """flax conv ``k/kernel`` [k, in, out] -> torch ``t`` [out, in, k]."""
    _put(sd, t, f[f"{k}/kernel"].transpose(2, 1, 0), norm)
    if bias:
        sd[t + "bias"] = f[f"{k}/bias"]


def _linear(sd, f, t, k, bias=True):
    _put(sd, t, f[f"{k}/kernel"].T, None)
    if bias:
        sd[t + "bias"] = f[f"{k}/bias"]


def _conv1x1(sd, f, t, k):
    """flax Dense [in, out] -> torch k=1 Conv1d [out, in, 1]."""
    _put(sd, t, f[f"{k}/kernel"].T[:, :, None], None)
    sd[t + "bias"] = f[f"{k}/bias"]


def _gamma_beta(sd, f, t, k):
    sd[t + "gamma"] = f[f"{k}/gamma"]
    sd[t + "beta"] = f[f"{k}/beta"]


def _mha_ref(sd, f, t, k):
    for tname, fname in (("q", "q"), ("k", "k"), ("v", "v"), ("o", "out")):
        _conv1x1(sd, f, f"{t}conv_{tname}.", f"{k}/{fname}")


def _ffn_ref(sd, f, t, k):
    _conv1d(sd, f, t + "conv_1.", f"{k}/conv1/Conv_0")
    _conv1d(sd, f, t + "conv_2.", f"{k}/conv2/Conv_0")


def _text_encoder_ref(sd, f, t, k):
    sd[t + "emb.weight"] = f[f"{k}/emb/embedding"]
    for i in _indices(f, f"{k}/prenet/conv_"):
        _conv1d(sd, f, f"{t}prenet.conv_layers.{i}.",
                f"{k}/prenet/conv_{i}/Conv_0")
        _gamma_beta(sd, f, f"{t}prenet.norm_layers.{i}.",
                    f"{k}/prenet/norm_{i}")
    _conv1d(sd, f, t + "prenet.proj.", f"{k}/prenet/proj")
    _transformer_ref(sd, f, t + "encoder.", f"{k}/encoder")
    _conv1d(sd, f, t + "proj_m.", f"{k}/proj_m")


def _transformer_ref(sd, f, t, k):
    for i in _indices(f, f"{k}/attn_"):
        _mha_ref(sd, f, f"{t}attn_layers.{i}.", f"{k}/attn_{i}")
        _ffn_ref(sd, f, f"{t}ffn_layers.{i}.", f"{k}/ffn_{i}")
        _gamma_beta(sd, f, f"{t}norm_layers_1.{i}.", f"{k}/norm1_{i}")
        _gamma_beta(sd, f, f"{t}norm_layers_2.{i}.", f"{k}/norm2_{i}")


def _hubert_encoder_ref(sd, f, t, k):
    _conv1d(sd, f, t + "phone_emb.", f"{k}/phone_emb")
    _transformer_ref(sd, f, t + "encoder.", f"{k}/encoder")


def _text_style_encoder_ref(sd, f, t, k):
    _conv1d(sd, f, t + "conv_in.", f"{k}/conv_in/Conv_0")
    for i in _indices(f, f"{k}/block_"):
        p, b = f"{t}blocks.{i}.", f"{k}/block_{i}"
        _conv1d(sd, f, p + "dwconv.", f"{b}/dwconv/Conv_0")
        sd[p + "norm.weight"] = f[f"{b}/LayerNorm_0/scale"]
        sd[p + "norm.bias"] = f[f"{b}/LayerNorm_0/bias"]
        _linear(sd, f, p + "pwconv1.", f"{b}/pwconv1")
        _gamma_beta(sd, f, p + "grn.", f"{b}/GRN_0")
        _linear(sd, f, p + "pwconv2.", f"{b}/pwconv2")


def _prosody_encoder_ref(sd, f, t, k):
    for i in _indices(f, f"{k}/attn_"):
        _mha_ref(sd, f, f"{t}attn_layers.{i}.", f"{k}/attn_{i}")
        _ffn_ref(sd, f, f"{t}ffn_layers.{i}.", f"{k}/ffn_{i}")
        _linear(sd, f, f"{t}norm_layers_1.{i}.fc.", f"{k}/norm1_{i}/fc")
        _linear(sd, f, f"{t}norm_layers_2.{i}.fc.", f"{k}/norm2_{i}/fc")
        _conv1d(sd, f, f"{t}proj_layers.{i}.", f"{k}/proj_{i}")


def _adain_block_ref(sd, f, t, k):
    _conv1d(sd, f, t + "conv1.", f"{k}/conv1/Conv_0", norm="param")
    _conv1d(sd, f, t + "conv2.", f"{k}/conv2/Conv_0", norm="param")
    _linear(sd, f, t + "norm1.fc.", f"{k}/AdaptiveInstanceNorm_0/fc")
    _linear(sd, f, t + "norm2.fc.", f"{k}/AdaptiveInstanceNorm_1/fc")
    if f"{k}/conv1x1/kernel" in f:
        _conv1d(sd, f, t + "conv1x1.", f"{k}/conv1x1", norm="param",
                bias=False)


def _wavenet_ref(sd, f, t, k):
    for i in _indices(f, f"{k}/in_"):
        _conv1d(sd, f, f"{t}in_layers.{i}.", f"{k}/in_{i}/Conv_0",
                norm="legacy")
        _linear(sd, f, f"{t}res_skip_layers.{i}.", f"{k}/res_skip_{i}")
    if f"{k}/cond_layer/kernel" in f:
        _linear(sd, f, t + "cond_layer.", f"{k}/cond_layer")


def _heads_ref(sd, f, t, k):
    for head in ("proj_mean", "proj_logstd"):
        _linear(sd, f, f"{t}{head}.", f"{k}{head}")


def _pitch_energy_ref(f: Flat) -> Flat:
    sd: Flat = {}
    _prosody_encoder_ref(sd, f, "prosody_encoder.", "prosody_encoder")
    _linear(sd, f, "query_norm.fc.", "query_norm/fc")
    _linear(sd, f, "key_norm.fc.", "key_norm/fc")
    _mha_ref(sd, f, "cross_attention.", "cross_attention")
    _conv1d(sd, f, "cross_post.0.", "cross_post_dw/Conv_0")
    _conv1d(sd, f, "cross_post.2.", "cross_post_pw")
    _f0_energy_heads_ref(sd, f)
    return sd


def _f0_energy_heads_ref(sd, f):
    for tname, fname in (("F0", "f0_block"), ("N", "energy_block")):
        for i in range(3):
            _adain_block_ref(sd, f, f"{tname}.{i}.", f"{fname}_{i}")
    _conv1d(sd, f, "F0_proj.", "f0_proj")
    _conv1d(sd, f, "N_proj.", "energy_proj")


def _hubert_pitch_energy_ref(f: Flat) -> Flat:
    sd: Flat = {}
    _conv1d(sd, f, "phone_quant.", "phone_quant")
    _linear(sd, f, "style_encoder.", "style_encoder")
    _prosody_encoder_ref(sd, f, "prosody_encoder.", "prosody_encoder")
    _f0_energy_heads_ref(sd, f)
    return sd


def _duration_ref(f: Flat) -> Flat:
    sd: Flat = {}
    _text_encoder_ref(sd, f, "text_encoder.", "text_encoder")
    _text_style_encoder_ref(sd, f, "style_encoder.", "style_encoder")
    _prosody_encoder_ref(sd, f, "prosody_encoder.", "prosody_encoder")
    _linear(sd, f, "duration_proj.linear_layer.", "duration_proj")
    return sd


def _speech_ref(f: Flat) -> Flat:
    sd: Flat = {}
    _text_encoder_ref(sd, f, "text_encoder.", "text_encoder")
    _text_style_encoder_ref(sd, f, "style_encoder.", "style_encoder")
    _speech_back_end_ref(sd, f)
    return sd


def _hubert_speech_ref(f: Flat) -> Flat:
    sd: Flat = {}
    _hubert_encoder_ref(sd, f, "phone_encoder.", "phone_encoder")
    for j, idx in enumerate((0, 3, 6)):
        _linear(sd, f, f"style_encoder.{idx}.", f"style{j + 1}")
    _speech_back_end_ref(sd, f)
    return sd


def _speech_back_end_ref(sd, f):
    """The decoder, flow, posterior and prior heads and the freegan
    generator, which both speech predictors share."""
    _conv1d(sd, f, "decoder.F0_conv.", "decoder/f0_conv/Conv_0",
            norm="param")
    _conv1d(sd, f, "decoder.N_conv.", "decoder/n_conv/Conv_0", norm="param")
    _conv1d(sd, f, "decoder.asr_res.0.", "decoder/asr_res", norm="param")
    _adain_block_ref(sd, f, "decoder.encode.", "decoder/encode")
    for i in range(4):
        _adain_block_ref(sd, f, f"decoder.decode.{i}.", f"decoder/decode_{i}")
    for i in _indices(f, "flow/flow_"):
        p, b = f"flow.flows.{2 * i}.", f"flow/flow_{i}"
        _linear(sd, f, p + "pre.", f"{b}/pre")
        _wavenet_ref(sd, f, p + "enc.", f"{b}/enc")
        _heads_ref(sd, f, p, f"{b}/")
    _conv1d(sd, f, "posterior_encoder.pre_spec.", "posterior_encoder/pre_spec")
    _conv1d(sd, f, "posterior_encoder.pre_phase.",
            "posterior_encoder/pre_phase")
    _wavenet_ref(sd, f, "posterior_encoder.enc.", "posterior_encoder/enc")
    _heads_ref(sd, f, "posterior_encoder.", "posterior_encoder/")
    _heads_ref(sd, f, "prior_encoder.", "prior_encoder/")
    _linear(sd, f, "post_flow.", "post_flow")
    g = "generator"
    _conv1d(sd, f, "generator.projector.", f"{g}/projector")
    for name in ("amp_prior_conv", "phase_prior_conv", "amp_output_conv",
                 "phase_output_conv"):
        _conv1d(sd, f, f"generator.{name}.", f"{g}/{name}/Conv_0")
    for i in _indices(f, f"{g}/convnext_"):
        p, b = f"generator.convnext.{i}.", f"{g}/convnext_{i}"
        _conv1d(sd, f, p + "dwconv.", f"{b}/dwconv/Conv_0")
        _linear(sd, f, p + "norm.fc.", f"{b}/AdaptiveLayerNorm_0/fc")
        _linear(sd, f, p + "pwconv1.", f"{b}/pwconv1")
        _gamma_beta(sd, f, p + "grn.", f"{b}/GRN_0")
        _linear(sd, f, p + "pwconv2.", f"{b}/pwconv2")
    for tname, fname in (("amp_final_layer_norm", "amp_final_norm"),
                         ("phase_final_layer_norm", "phase_final_norm")):
        _linear(sd, f, f"generator.{tname}.fc.", f"{g}/{fname}/fc")


def _spectral_ref(sd, f, t, k, bias=True):
    """One spectral-norm conv: ``weight_orig`` in torch layout, ``weight_u``
    the flax ``u`` and ``weight_v`` = normalize(W^T u); returns sigma =
    u W v, as the converter computes it from those three."""
    w = np.ascontiguousarray(f[f"{k}/Conv_0/kernel"].transpose(3, 2, 0, 1))
    u = f[f"{k}/SpectralNorm_0/Conv_0/kernel/u"].reshape(-1)
    w_mat = w.reshape(w.shape[0], -1)
    v = w_mat.T @ u
    v = (v / np.sqrt(np.sum(v * v) + 1e-12)).astype(np.float32)
    sd[t + "weight_orig"] = w
    sd[t + "weight_u"] = u
    sd[t + "weight_v"] = v
    if bias:
        sd[t + "bias"] = f[f"{k}/Conv_0/bias"]
    return np.asarray(float(u @ w_mat @ v), np.float32)


def _mel_style_ref(f: Flat) -> Tuple[Flat, Flat]:
    sd: Flat = {}
    sigmas: Flat = {}

    def add(t, k, bias=True):
        sigmas[f"{k}/SpectralNorm_0/Conv_0/kernel/sigma"] = _spectral_ref(
            sd, f, t, k, bias)

    add("shared.0.", "conv_in")
    for i in range(4):
        blk, r = f"shared.{i + 1}.", f"res_{i}"
        add(blk + "conv1.", f"{r}/conv1")
        add(blk + "conv2.", f"{r}/conv2")
        if f"{r}/downconv/Conv_0/kernel" in f:
            add(blk + "downsample_res.conv.", f"{r}/downconv")
        if f"{r}/conv1x1/Conv_0/kernel" in f:
            add(blk + "conv1x1.", f"{r}/conv1x1", bias=False)
    add("shared.6.", "conv_out")
    _linear(sd, f, "unshared.", "unshared")
    return sd, sigmas


def _aligner_ref(f: Flat) -> Flat:
    sd: Flat = {}
    for i in range(3):
        p = f"encoder.layers.{i}."
        _conv1d(sd, f, p + "0.", f"tdnn_{i}/Conv_0")
        sd[p + "2.running_mean"] = f[f"bn_{i}/mean"]
        sd[p + "2.running_var"] = f[f"bn_{i}/var"]
    for j, idx in enumerate((0, 3, 6, 9, 12)):
        _linear(sd, f, f"encoder.layers.3.ffn.{idx}.", f"ffn_{j}")
    _linear(sd, f, "encoder_output_layer.", "out")
    return sd


def _wn_conv2d_ref(sd: Flat, f: Flat, t: str, scope: str, i: int,
                   name: str) -> None:
    """One flax ``WeightNorm(Conv)`` of ``scope`` as the reference's
    parametrized conv: g the scale, v the kernel."""
    w = np.ascontiguousarray(f[f"{scope}/{name}/kernel"].transpose(3, 2, 0, 1))
    g = f[f"{scope}/WeightNorm_{i}/{name}/kernel/scale"]
    sd[t + "parametrizations.weight.original0"] = g.reshape(
        (-1,) + (1,) * (w.ndim - 1))
    sd[t + "parametrizations.weight.original1"] = w
    sd[t + "bias"] = f[f"{scope}/{name}/bias"]


def _mrd_ref(f: Flat) -> Flat:
    sd: Flat = {}
    for d in _indices(f, "disc_"):
        convs = [(f"discriminators.{d}.discriminators.{i}.", i, f"conv_{i}")
                 for i in range(5)]
        for t, i, name in convs + [(f"discriminators.{d}.out.", 5, "out")]:
            _wn_conv2d_ref(sd, f, t, f"disc_{d}", i, name)
    return sd


def _mpd_ref(f: Flat) -> Flat:
    sd: Flat = {}
    periods = sorted(_indices(f, "period_"))
    for d, p in enumerate(periods):
        convs = [(f"discriminators.{d}.convs.{i}.", i, f"conv_{i}")
                 for i in range(5)]
        for t, i, name in convs + [(f"discriminators.{d}.conv_post.", 5,
                                    "out")]:
            _wn_conv2d_ref(sd, f, t, f"period_{p}", i, name)
    return sd


def _sub_flat(f: Flat, k: str) -> Flat:
    return {n[len(k) + 1:]: v for n, v in f.items() if n.startswith(k + "/")}


def _style_convnext_ref(sd, f, t, k):
    _conv1d(sd, f, t + "dwconv.", f"{k}/dwconv/Conv_0")
    _linear(sd, f, t + "norm.fc.", f"{k}/AdaptiveLayerNorm_0/fc")
    _linear(sd, f, t + "pwconv1.", f"{k}/pwconv1")
    _gamma_beta(sd, f, t + "grn.", f"{k}/GRN_0")
    _linear(sd, f, t + "pwconv2.", f"{k}/pwconv2")


def _cfm_pitch_ref(f: Flat) -> Tuple[Flat, Flat]:
    sd: Flat = {}
    _conv1d(sd, f, "asr_emb.0.", "asr_emb1")
    _conv1d(sd, f, "asr_emb.2.", "asr_emb2")
    _conv1d(sd, f, "out_proj.", "out_proj")
    spk, sigmas = _mel_style_ref(_sub_flat(f, "spk_emb"))
    sd.update({f"spk_emb.{n}": v for n, v in spk.items()})
    for i in _indices(f, "block_"):
        _style_convnext_ref(sd, f, f"blocks.{i}.", f"block_{i}")
    return sd, {f"spk_emb/{n}": v for n, v in sigmas.items()}


def _layer_norm_ref(sd, f, t, k):
    sd[t + "weight"] = f[f"{k}/scale"]
    sd[t + "bias"] = f[f"{k}/bias"]


def _xut_block_ref(sd, f, t, k):
    _linear(sd, f, t + "attn.qkv.", f"{k}/attn/qkv", bias=False)
    _linear(sd, f, t + "attn.out.", f"{k}/attn/out")
    sd[t + "attn.rope.freqs"] = f[f"{k}/attn/rope/freqs"]
    _linear(sd, f, t + "mlp.w12.", f"{k}/mlp/w12")
    _linear(sd, f, t + "mlp.w3.", f"{k}/mlp/w3")
    for norm in ("attn_pre_norm", "mlp_pre_norm"):
        sd[f"{t}{norm}.norm.weight"] = f[f"{k}/{norm}/norm/scale"]
    if f"{k}/xattn/q/kernel" in f:
        _linear(sd, f, t + "xattn.q.", f"{k}/xattn/q", bias=False)
        _linear(sd, f, t + "xattn.kv.", f"{k}/xattn/kv", bias=False)
        _linear(sd, f, t + "xattn.out.", f"{k}/xattn/out")
        sd[t + "xattn.rope.freqs"] = f[f"{k}/xattn/rope/freqs"]
        sd[t + "xattn_pre_norm.norm.weight"] = f[
            f"{k}/xattn_pre_norm/norm/scale"]


def _cfm_mel_ref(f: Flat) -> Flat:
    sd: Flat = {}
    for t, k in (("time_emb.proj.0.", "time_emb/proj"),
                 ("asr_emb.1.", "asr_emb1"), ("asr_emb.3.", "asr_emb2"),
                 ("spk_emb.0.", "spk_emb1"), ("spk_emb.2.", "spk_emb2"),
                 ("in_proj.", "in_proj"), ("out_proj.0.", "out_proj")):
        _linear(sd, f, t, k)
    _linear(sd, f, "m_source.1.merge.0.", "m_source/merge", bias=False)
    _conv1d(sd, f, "prior_generator.1.", "prior_generator")
    for t, k in (("shared_adaln_attn.", "shared_attn"),
                 ("shared_adaln_xattn.", "shared_xattn"),
                 ("shared_adaln_ffw.", "shared_ffw")):
        _layer_norm_ref(sd, f, t + "0.", f"{k}/ln")
        _linear(sd, f, t + "1.", f"{k}/fc1")
        _linear(sd, f, t + "3.", f"{k}/fc2")
    blocks = {n.split("/")[1] for n in f if n.startswith("backbone/")}
    for name in blocks:  # enc_{d}_{i} / dec_{d}_{i}
        side, d, i = name.split("_")
        _xut_block_ref(sd, f, f"backbone.{side}_blocks.{d}.{i}.",
                       f"backbone/{name}")
    for t, k in (("prev_tread_trns.blocks.", "prev_tread/block_"),
                 ("post_tread_trns.blocks.", "post_tread/block_")):
        for i in _indices(f, k):
            _xut_block_ref(sd, f, f"{t}{i}.", f"{k}{i}")
    return sd


def _bn_ref(sd, f, t, k):
    """A flax batch norm (``scale``, ``bias``, ``mean``, ``var``) as
    torch's BatchNorm keys."""
    _layer_norm_ref(sd, f, t, k)
    sd[t + "running_mean"] = f[f"{k}/mean"]
    sd[t + "running_var"] = f[f"{k}/var"]


def _conv2d_ref(sd, f, t, k, bias=False):
    """flax 2-D conv ``k/kernel`` [kh, kw, in, out] -> torch ``t``
    [out, in, kh, kw]."""
    _put(sd, t, f[f"{k}/kernel"].transpose(3, 2, 0, 1), None)
    if bias:
        sd[t + "bias"] = f[f"{k}/bias"]


def _conv_block_res_ref(sd, f, t, k):
    for j, idx in enumerate((0, 3)):
        _conv2d_ref(sd, f, f"{t}conv.{idx}.", f"{k}/conv_{j}")
        _bn_ref(sd, f, f"{t}conv.{idx + 1}.", f"{k}/bn_{j}")
    if f"{k}/shortcut/kernel" in f:
        _conv2d_ref(sd, f, t + "shortcut.", f"{k}/shortcut", bias=True)


def _gru_ref(sd, f, t, sfx, k):
    """A flax GRUCell as one direction of torch's GRU (gates r, z, n): the
    r and z gates' hidden bias is written as 0, so the converter's sum
    b_ih + b_hh gives the flax bias back exactly."""
    hn_bias = f[f"{k}/hn/bias"]
    zeros = np.zeros_like(hn_bias)
    for side, gates in (("ih", ("ir", "iz", "in")),
                        ("hh", ("hr", "hz", "hn"))):
        sd[f"{t}weight_{side}_l0{sfx}"] = np.ascontiguousarray(
            np.concatenate([f[f"{k}/{g}/kernel"].T for g in gates]))
    sd[f"{t}bias_ih_l0{sfx}"] = np.concatenate(
        [f[f"{k}/{g}/bias"] for g in ("ir", "iz", "in")])
    sd[f"{t}bias_hh_l0{sfx}"] = np.concatenate([zeros, zeros, hn_bias])


def _rmvpe_ref(f: Flat) -> Flat:
    sd: Flat = {}
    _bn_ref(sd, f, "unet.encoder.bn.", "in_bn")
    for part, scope in (("encoder", "enc_"), ("intermediate", "inter_"),
                        ("decoder", "dec_")):
        for i in _indices(f, scope):
            t = f"unet.{part}.layers.{i}."
            convs = "conv2" if part == "decoder" else "conv"
            for j in _indices(f, f"{scope}{i}/block_"):
                _conv_block_res_ref(sd, f, f"{t}{convs}.{j}.",
                                    f"{scope}{i}/block_{j}")
            if part == "decoder":  # torch ConvTranspose2d [in, out, kh, kw]
                sd[t + "conv1.0.weight"] = np.ascontiguousarray(np.flip(
                    f[f"dec_{i}/up/kernel"], (0, 1)).transpose(2, 3, 0, 1))
                _bn_ref(sd, f, t + "conv1.1.", f"dec_{i}/bn")
    _conv2d_ref(sd, f, "cnn.", "cnn", bias=True)
    _gru_ref(sd, f, "fc.0.gru.", "", "gru/fwd")
    _gru_ref(sd, f, "fc.0.gru.", "_reverse", "gru/bwd")
    _linear(sd, f, "fc.1.", "head")
    return sd


def _wespeaker_ref(f: Flat) -> Flat:
    sd: Flat = {}
    _conv2d_ref(sd, f, "front.conv1.", "front/conv1")
    _bn_ref(sd, f, "front.bn1.", "front/bn1")
    for s in range(1, 5):
        for i in _indices(f, f"front/layer{s}_"):
            t, k = f"front.layer{s}.{i}.", f"front/layer{s}_{i}"
            for n in (1, 2):
                _conv2d_ref(sd, f, f"{t}conv{n}.", f"{k}/conv{n}")
                _bn_ref(sd, f, f"{t}bn{n}.", f"{k}/bn{n}")
            if f"{k}/downsample_conv/kernel" in f:
                _conv2d_ref(sd, f, t + "downsample.0.", f"{k}/downsample_conv")
                _bn_ref(sd, f, t + "downsample.1.", f"{k}/downsample_bn")
    _conv1d(sd, f, "pooling.attention.0.", "pooling/att_in")
    _bn_ref(sd, f, "pooling.attention.2.", "pooling/att_bn")
    _conv1d(sd, f, "pooling.attention.3.", "pooling/att_out")
    return sd


def _vocos_ref(f: Flat) -> Flat:
    sd: Flat = {}
    _conv1d(sd, f, "backbone.embed.", "embed/Conv_0")
    _layer_norm_ref(sd, f, "backbone.norm.", "norm")
    for i in _indices(f, "convnext_"):
        t, k = f"backbone.convnext.{i}.", f"convnext_{i}"
        _conv1d(sd, f, t + "dwconv.", f"{k}/dwconv/Conv_0")
        _layer_norm_ref(sd, f, t + "norm.", f"{k}/norm")
        _linear(sd, f, t + "pwconv1.", f"{k}/pwconv1")
        _linear(sd, f, t + "pwconv2.", f"{k}/pwconv2")
        sd[t + "gamma"] = f[f"{k}/gamma"]
    _layer_norm_ref(sd, f, "backbone.final_layer_norm.", "final_layer_norm")
    _linear(sd, f, "head.out.", "out")
    return sd


def _top_level(write, f: Flat) -> Flat:
    """``write``'s state dict of a model whose converter reads the
    reference module itself, not a submodule of it."""
    sd: Flat = {}
    write(sd, {f"m/{k}": v for k, v in f.items()}, "", "m")
    return sd


_REFERENCE_WRITERS = {
    "pe_text_encoder": lambda f: _top_level(_text_encoder_ref, f),
    "pe_text_style_encoder": lambda f: _top_level(_text_style_encoder_ref, f),
    "duration_predictor": _duration_ref,
    "pitch_energy_predictor": _pitch_energy_ref,
    "speech_predictor": _speech_ref,
    "text_aligner": _aligner_ref,
    "mrd": _mrd_ref,
    "mpd": _mpd_ref,
    "hubert_encoder": lambda f: _top_level(_hubert_encoder_ref, f),
    "hubert_speech_predictor": _hubert_speech_ref,
    "hubert_pitch_energy_predictor": _hubert_pitch_energy_ref,
    "cfm_mel_decoder": _cfm_mel_ref,
    "wespeaker": _wespeaker_ref,
    "vocos": _vocos_ref,
    "rmvpe": _rmvpe_ref,
}
# writers that also return the spectral norms' sigma = u W v of what they
# wrote, by flax batch-stat name
_SPECTRAL_WRITERS = {
    "pe_mel_style_encoder": _mel_style_ref,
    "cfm_pitch_predictor": _cfm_pitch_ref,
}


def reference_state_dict(name: str, module) -> Flat:
    """The torch reference's ``state_dict`` (numpy arrays, its key names
    and layouts) that holds ``module``'s weights as model ``name``: one of
    the converters' 16 models or ``rmvpe``.

    The spectral norms (the mel style encoder's, the CFM pitch predictor's
    speaker branch's): ``u`` is the module's, ``v`` one power-iteration
    step from it, and the module's ``sigma`` buffers are set, in place, to
    u W v of those, the value the converter derives from the written
    state."""
    import torch

    from ..convert import export_flax_params

    f = export_flax_params(name, module)
    if name not in _SPECTRAL_WRITERS:
        return _REFERENCE_WRITERS[name](f)
    sd, sigmas = _SPECTRAL_WRITERS[name](f)
    state = module.state_dict()
    for key, sigma in sigmas.items():
        path = key.split("/SpectralNorm_0/")[0].replace("/", ".")
        state[f"{path}.sigma"].copy_(torch.from_numpy(sigma))
    return sd


def write_reference_checkpoint(out_dir: Path, models: Dict,
                               safetensors: Sequence[str] = ()) -> Dict:
    """Write ``models`` ({name: the port's module}) as an accelerator
    ``save_state`` directory of the torch reference: each model's
    ``reference_state_dict`` at its index in ``REFERENCE_SAVE_ORDER``, as
    ``model[_N].safetensors`` for the names in ``safetensors`` and as
    ``pytorch_model[_N].bin`` (``torch.save``) for the rest.  Returns
    {name: path}."""
    import torch

    from ..export.import_torch import REFERENCE_SAVE_ORDER

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written = {}
    for name, module in models.items():
        index = REFERENCE_SAVE_ORDER.index(name)
        suffix = "" if index == 0 else f"_{index}"
        sd = reference_state_dict(name, module)
        if name in safetensors:
            path = out / f"model{suffix}.safetensors"
            write_safetensors(path, sd)
        else:
            path = out / f"pytorch_model{suffix}.bin"
            torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in sd.items()}, path)
        written[name] = path
    return written


def ssl_state_dict(module) -> Flat:
    """The HF ``transformers`` ``state_dict`` (WavLM's key names and
    layouts where ``module.rel_pos_bias``, else HuBERT's) that holds the
    port's ``SLMFeatureExtractor`` ``module``: the inverse of
    ``models/slm_convert.py:convert_wavlm_state_dict``.  The positional
    conv is weight-normed as ``parametrizations.weight.original0`` (g, the
    norm over the output and input axes at each tap) and ``original1``
    (v, the kernel)."""
    from ..convert import export_flax_params

    f = export_flax_params("slm", module)
    sd: Flat = {}
    fe, fp = "feature_extractor.conv_layers.", "feature_projection."
    for i in _indices(f, "conv_"):
        sd[f"{fe}{i}.conv.weight"] = np.ascontiguousarray(
            f[f"conv_{i}/kernel"].transpose(2, 1, 0))
    _layer_norm_ref(sd, f, fe + "0.layer_norm.", "gn")
    _layer_norm_ref(sd, f, fp + "layer_norm.", "fp_ln")
    _linear(sd, f, fp + "projection.", "feature_proj")
    w = np.ascontiguousarray(f["pos_conv/kernel"].transpose(2, 1, 0))
    pos = "encoder.pos_conv_embed.conv."
    sd[pos + "parametrizations.weight.original0"] = np.linalg.norm(
        w, axis=(0, 1), keepdims=True).astype(np.float32)
    sd[pos + "parametrizations.weight.original1"] = w
    sd[pos + "bias"] = f["pos_conv/bias"]
    _layer_norm_ref(sd, f, "encoder.layer_norm.", "encoder_ln")
    gated = "rel_attn_embed" in f
    if gated:
        sd["encoder.layers.0.attention.rel_attn_embed.weight"] = f[
            "rel_attn_embed"]
    for i in range(module.n_layers):
        t, a = f"encoder.layers.{i}.", f"layer_{i}_attn"
        for proj in ("q_proj", "k_proj", "v_proj"):  # [in, h, d]
            kernel = f[f"{a}/{proj}/kernel"]
            sd[f"{t}attention.{proj}.weight"] = np.ascontiguousarray(
                kernel.reshape(kernel.shape[0], -1).T)
            sd[f"{t}attention.{proj}.bias"] = f[f"{a}/{proj}/bias"].reshape(-1)
        kernel = f[f"{a}/out_proj/kernel"]  # [h, d, out]
        sd[f"{t}attention.out_proj.weight"] = np.ascontiguousarray(
            kernel.reshape(-1, kernel.shape[-1]).T)
        sd[f"{t}attention.out_proj.bias"] = f[f"{a}/out_proj/bias"]
        if gated:
            _linear(sd, f, f"{t}attention.gru_rel_pos_linear.",
                    f"{a}/gru_rel_pos_linear")
            sd[f"{t}attention.gru_rel_pos_const"] = f[
                f"{a}/gru_rel_pos_const"].reshape(1, -1, 1, 1)
        _layer_norm_ref(sd, f, t + "layer_norm.", f"layer_{i}_ln1")
        _linear(sd, f, t + "feed_forward.intermediate_dense.",
                f"layer_{i}_fc1")
        _linear(sd, f, t + "feed_forward.output_dense.", f"layer_{i}_fc2")
        _layer_norm_ref(sd, f, t + "final_layer_norm.", f"layer_{i}_ln2")
    return sd


def write_ssl_checkpoint(out_dir: Path, module) -> Path:
    """``module`` (the port's ``SLMFeatureExtractor``) as a local HF
    checkpoint directory, ``config.json`` and ``model.safetensors``
    (``ssl_state_dict``), the input of ``scripts/convert_wavlm.py`` and
    ``scripts/convert_hubert.py``.  Returns the directory."""
    import json

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    write_safetensors(out / "model.safetensors", ssl_state_dict(module))
    attn = module.layer_0_attn
    (out / "config.json").write_text(json.dumps({
        "model_type": "wavlm" if module.rel_pos_bias else "hubert",
        "num_hidden_layers": module.n_layers,
        "num_attention_heads": attn.n_heads,
        "hidden_size": module.feature_proj.out_features}))
    return out


def seeded_rmvpe(seed: int, **widths):
    """An RMVPE net (``dataprep/rmvpe.py``; the published widths unless
    ``widths`` narrows it) drawn from ``seed``: the flax initialisers'
    distributions, then its batch norms away from the identity (scale and
    bias 1 + 0.1 N and 0.1 N, running mean 0.1 N, running variance
    exp(0.2 N)), so a converted file carries statistics that matter."""
    import torch

    from ..dataprep.rmvpe import RMVPE
    from ..models.wespeaker import FrozenBatchNorm
    from ..train.init import init_params

    generator = torch.Generator().manual_seed(seed)
    model = init_params(RMVPE(**widths), generator)
    with torch.no_grad():
        for bn in model.modules():
            if isinstance(bn, FrozenBatchNorm):
                n = [torch.randn(bn.mean.shape, generator=generator)
                     for _ in range(4)]
                bn.weight.copy_(1.0 + 0.1 * n[0])
                bn.bias.copy_(0.1 * n[1])
                bn.mean.copy_(0.1 * n[2])
                bn.var.copy_(torch.exp(0.2 * n[3]))
    return model.eval()
