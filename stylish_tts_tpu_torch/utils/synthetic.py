"""Synthetic data for smoke runs and tests: a sine-speech dataset, the
down-scaled model config, and a torch reference checkpoint written from
the port's modules.

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


def _linear(sd, f, t, k):
    _put(sd, t, f[f"{k}/kernel"].T, None)
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
    for i in _indices(f, f"{k}/encoder/attn_"):
        e = f"{t}encoder."
        _mha_ref(sd, f, f"{e}attn_layers.{i}.", f"{k}/encoder/attn_{i}")
        _ffn_ref(sd, f, f"{e}ffn_layers.{i}.", f"{k}/encoder/ffn_{i}")
        _gamma_beta(sd, f, f"{e}norm_layers_1.{i}.", f"{k}/encoder/norm1_{i}")
        _gamma_beta(sd, f, f"{e}norm_layers_2.{i}.", f"{k}/encoder/norm2_{i}")
    _conv1d(sd, f, t + "proj_m.", f"{k}/proj_m")


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
    for tname, fname in (("F0", "f0_block"), ("N", "energy_block")):
        for i in range(3):
            _adain_block_ref(sd, f, f"{tname}.{i}.", f"{fname}_{i}")
    _conv1d(sd, f, "F0_proj.", "f0_proj")
    _conv1d(sd, f, "N_proj.", "energy_proj")
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
    return sd


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


def _mrd_ref(f: Flat) -> Flat:
    sd: Flat = {}
    for d in _indices(f, "disc_"):
        convs = [(f"discriminators.{d}.discriminators.{i}.", i, f"conv_{i}")
                 for i in range(5)]
        for t, i, name in convs + [(f"discriminators.{d}.out.", 5, "out")]:
            k = f"disc_{d}/{name}/kernel"
            w = np.ascontiguousarray(f[k].transpose(3, 2, 0, 1))
            g = f[f"disc_{d}/WeightNorm_{i}/{name}/kernel/scale"]
            sd[t + "parametrizations.weight.original0"] = g.reshape(
                (-1,) + (1,) * (w.ndim - 1))
            sd[t + "parametrizations.weight.original1"] = w
            sd[t + "bias"] = f[f"disc_{d}/{name}/bias"]
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
}


def reference_state_dict(name: str, module) -> Flat:
    """The torch reference's ``state_dict`` (numpy arrays, its key names
    and layouts) that holds ``module``'s weights as model ``name``.

    The mel style encoder's spectral norms: ``u`` is the module's, ``v``
    one power-iteration step from it, and the module's ``sigma`` buffers
    are set, in place, to u W v of those, the value the converter derives
    from the written state."""
    import torch

    from ..convert import export_flax_params

    f = export_flax_params(name, module)
    if name != "pe_mel_style_encoder":
        return _REFERENCE_WRITERS[name](f)
    sd, sigmas = _mel_style_ref(f)
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
