"""Convert the torch reference's model weights into flat flax names: the
port's copy of the JAX package's converters, all of them.

The reference (stylish-tts) trains pure-torch modules; each converter
re-lays one module's ``state_dict`` into the flat ``{"a/b/kernel":
array}`` dict of the flax tree, which ``convert.load_flax_params`` maps
onto the port's module by name.  So a reference checkpoint reaches the port
through the JAX package's layout, and the two packages read it alike.

Covered models (reference train/models/models.py names):
  pe_text_encoder                     (text_encoder.py:396-462)
  pe_text_style_encoder               (text_style_encoder.py:6-26)
  pe_mel_style_encoder                (mel_style_encoder.py:120-151)
  duration_predictor                  (duration_predictor.py:8-36)
  pitch_energy_predictor              (pitch_energy_predictor.py:11-121)
  speech_predictor                    (speech_predictor.py:14-129)
  text_aligner                        (text_aligner.py:33-127)
  mrd, mpd                            (discriminator.py:31-248)
  hubert_encoder                      (hubert_encoder.py:7-47)
  hubert_speech_predictor             (speech_predictor.py:132-251)
  hubert_pitch_energy_predictor       (pitch_energy_predictor.py:124-191)
  cfm_pitch_predictor                 (cfm/cfm_pitch_predictor.py:12-53)
  cfm_mel_decoder                     (cfm/cfm_mel_decoder.py:193-418)
and the pretrained frozen nets: wespeaker (the SimAM-ResNet34 speaker
net), vocos (the Vocos mel vocoder) and rmvpe (the RMVPE pitch net, reached
only through ``scripts/convert_rmvpe.py``).

torch parametrizations are folded offline: weight-norm (both the legacy
``weight_g``/``weight_v`` pair and ``parametrizations.weight.original0/1``)
into plain kernels, except the MRD's and the MPD's, whose direction and
norm stay apart as the flax ``WeightNorm`` keeps them; spectral-norm
(``weight_orig``/``weight_u``/``weight_v``) stays unnormalised with the
(u, sigma) power-iteration state emitted as batch stats, matching flax
``nn.SpectralNorm``.  BatchNorm running stats become batch stats mean/var
(the frozen wespeaker net keeps them among its params, as the JAX package
does).

The arithmetic is numpy's, as in the JAX package, so both packages give
the same arrays bit for bit.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

Flat = Dict[str, np.ndarray]


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


# ---------------------------------------------------------------------------
# primitive re-layouts: torch -> flax
# ---------------------------------------------------------------------------

def conv1d_k(w) -> np.ndarray:
    """torch Conv1d weight (out, in, k) -> flax nn.Conv kernel (k, in, out)."""
    return np.ascontiguousarray(_np(w).transpose(2, 1, 0))


def conv2d_k(w) -> np.ndarray:
    """torch Conv2d weight (out, in, kh, kw) -> flax (kh, kw, in, out)."""
    return np.ascontiguousarray(_np(w).transpose(2, 3, 1, 0))


def linear_k(w) -> np.ndarray:
    """torch Linear weight (out, in) -> flax Dense kernel (in, out)."""
    return np.ascontiguousarray(_np(w).T)


def conv1x1_to_dense(w) -> np.ndarray:
    """torch Conv1d k=1 weight (out, in, 1) -> flax Dense kernel (in, out)."""
    return np.ascontiguousarray(_np(w)[:, :, 0].T)


def fold_weight_norm(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Fold torch weight-norm parametrizations into plain ``.weight`` keys.

    Handles the legacy ``weight_g``/``weight_v`` naming (flow.py WN layers)
    and the new ``parametrizations.weight.original0``/``original1`` naming
    (ada_norm.py blocks).  Norm is over all dims except 0 (torch dim=0
    default).  Spectral-norm triples (``weight_orig``) are left untouched.
    """
    out: Dict[str, np.ndarray] = {}
    done = set()
    for key in sd:
        if key in done:
            continue
        if key.endswith("weight_g"):
            base = key[: -len("weight_g")]
            g, v = _np(sd[key]), _np(sd[base + "weight_v"])
            done.add(base + "weight_v")
            norm = np.sqrt(
                np.sum(v.reshape(v.shape[0], -1) ** 2, axis=1)
            ).reshape((-1,) + (1,) * (v.ndim - 1))
            out[base + "weight"] = g.reshape(norm.shape) * v / norm
        elif key.endswith("parametrizations.weight.original0"):
            base = key[: -len("parametrizations.weight.original0")]
            g = _np(sd[key])
            v = _np(sd[base + "parametrizations.weight.original1"])
            done.add(base + "parametrizations.weight.original1")
            norm = np.sqrt(
                np.sum(v.reshape(v.shape[0], -1) ** 2, axis=1)
            ).reshape((-1,) + (1,) * (v.ndim - 1))
            out[base + "weight"] = g.reshape(norm.shape) * v / norm
        elif key.endswith("parametrizations.weight.original1"):
            continue  # handled with its original0
        elif key.endswith("weight_v") and key[: -len("weight_v")] + "weight_g" in sd:
            continue
        else:
            out[key] = _np(sd[key])
    return out


def _prefixed(prefix: str, flat: Flat) -> Flat:
    return {f"{prefix}/{k}": v for k, v in flat.items()}


def _sub(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _mha(sd: Dict[str, np.ndarray], prefix: str) -> Flat:
    """Reference MultiHeadAttention (conv_q/k/v/o, k=1 convs) -> q/k/v/out
    Dense params (text_encoder.py:171-296)."""
    out: Flat = {}
    for tname, fname in (("q", "q"), ("k", "k"), ("v", "v"), ("o", "out")):
        out[f"{fname}/kernel"] = conv1x1_to_dense(sd[f"{prefix}conv_{tname}.weight"])
        out[f"{fname}/bias"] = _np(sd[f"{prefix}conv_{tname}.bias"])
    return out


def _ffn(sd: Dict[str, np.ndarray], prefix: str) -> Flat:
    """Reference FFN (conv_1/conv_2) -> ConvFFN conv1/conv2."""
    return {
        "conv1/Conv_0/kernel": conv1d_k(sd[f"{prefix}conv_1.weight"]),
        "conv1/Conv_0/bias": _np(sd[f"{prefix}conv_1.bias"]),
        "conv2/Conv_0/kernel": conv1d_k(sd[f"{prefix}conv_2.weight"]),
        "conv2/Conv_0/bias": _np(sd[f"{prefix}conv_2.bias"]),
    }


# ---------------------------------------------------------------------------
# module converters
# ---------------------------------------------------------------------------

def _transformer_encoder(sd: Dict[str, np.ndarray], prefix: str) -> Flat:
    """Reference Encoder stack (text_encoder.py:332-393): per layer MHA +
    conv-FFN + two channel LayerNorms."""
    out: Flat = {}
    n_layers = max(
        int(k[len(prefix):].split(".")[1]) + 1
        for k in sd
        if k.startswith(prefix + "attn_layers.")
    )
    for i in range(n_layers):
        out.update(_prefixed(f"attn_{i}", _mha(sd, f"{prefix}attn_layers.{i}.")))
        out.update(_prefixed(f"ffn_{i}", _ffn(sd, f"{prefix}ffn_layers.{i}.")))
        for tn, fn in (("norm_layers_1", "norm1"), ("norm_layers_2", "norm2")):
            out[f"{fn}_{i}/gamma"] = _np(sd[f"{prefix}{tn}.{i}.gamma"])
            out[f"{fn}_{i}/beta"] = _np(sd[f"{prefix}{tn}.{i}.beta"])
    return out


def convert_text_encoder(sd: Dict[str, np.ndarray]) -> Flat:
    """Reference TextEncoder (text_encoder.py:396-462) -> flax TextEncoder."""
    sd = fold_weight_norm(sd)
    out: Flat = {"emb/embedding": _np(sd["emb.weight"])}
    n_prenet = max(
        int(k.split(".")[2]) + 1 for k in sd if k.startswith("prenet.conv_layers.")
    )
    for i in range(n_prenet):
        out[f"prenet/conv_{i}/Conv_0/kernel"] = conv1d_k(
            sd[f"prenet.conv_layers.{i}.weight"]
        )
        out[f"prenet/conv_{i}/Conv_0/bias"] = _np(sd[f"prenet.conv_layers.{i}.bias"])
        out[f"prenet/norm_{i}/gamma"] = _np(sd[f"prenet.norm_layers.{i}.gamma"])
        out[f"prenet/norm_{i}/beta"] = _np(sd[f"prenet.norm_layers.{i}.beta"])
    out["prenet/proj/kernel"] = conv1d_k(sd["prenet.proj.weight"])
    out["prenet/proj/bias"] = _np(sd["prenet.proj.bias"])
    out.update(_prefixed("encoder", _transformer_encoder(sd, "encoder.")))
    out["proj_m/kernel"] = conv1d_k(sd["proj_m.weight"])
    out["proj_m/bias"] = _np(sd["proj_m.bias"])
    return out


def convert_hubert_encoder(sd: Dict[str, np.ndarray]) -> Flat:
    """Reference HubertEncoder (hubert_encoder.py:7-47)."""
    sd = fold_weight_norm(sd)
    out: Flat = {
        "phone_emb/kernel": conv1d_k(sd["phone_emb.weight"]),
        "phone_emb/bias": _np(sd["phone_emb.bias"]),
    }
    out.update(_prefixed("encoder", _transformer_encoder(sd, "encoder.")))
    if "cond_proj.weight" in sd:
        out["cond_proj/kernel"] = linear_k(sd["cond_proj.weight"])
        out["cond_proj/bias"] = _np(sd["cond_proj.bias"])
    if "final_proj.weight" in sd:
        out["final_proj/kernel"] = conv1d_k(sd["final_proj.weight"])
        out["final_proj/bias"] = _np(sd["final_proj.bias"])
    return out


def convert_text_style_encoder(sd: Dict[str, np.ndarray]) -> Flat:
    """Reference TextStyleEncoder (text_style_encoder.py:6-26)."""
    sd = fold_weight_norm(sd)
    out: Flat = {
        "conv_in/Conv_0/kernel": conv1d_k(sd["conv_in.weight"]),
        "conv_in/Conv_0/bias": _np(sd["conv_in.bias"]),
    }
    n_blocks = max(int(k.split(".")[1]) + 1 for k in sd if k.startswith("blocks."))
    for i in range(n_blocks):
        p = f"blocks.{i}."
        out[f"block_{i}/dwconv/Conv_0/kernel"] = conv1d_k(sd[p + "dwconv.weight"])
        out[f"block_{i}/dwconv/Conv_0/bias"] = _np(sd[p + "dwconv.bias"])
        out[f"block_{i}/LayerNorm_0/scale"] = _np(sd[p + "norm.weight"])
        out[f"block_{i}/LayerNorm_0/bias"] = _np(sd[p + "norm.bias"])
        out[f"block_{i}/pwconv1/kernel"] = linear_k(sd[p + "pwconv1.weight"])
        out[f"block_{i}/pwconv1/bias"] = _np(sd[p + "pwconv1.bias"])
        out[f"block_{i}/GRN_0/gamma"] = _np(sd[p + "grn.gamma"])
        out[f"block_{i}/GRN_0/beta"] = _np(sd[p + "grn.beta"])
        out[f"block_{i}/pwconv2/kernel"] = linear_k(sd[p + "pwconv2.weight"])
        out[f"block_{i}/pwconv2/bias"] = _np(sd[p + "pwconv2.bias"])
    return out


def _spectral(
    sd: Dict[str, np.ndarray], tpfx: str, fpfx: str, bias: bool = True
) -> Tuple[Flat, Flat]:
    """One spectral-norm conv (mel_style_encoder.py old-style
    ``weight_orig``/``weight_u``/``weight_v``) -> flax params + batch_stats.

    flax nn.SpectralNorm keeps the raw kernel as the param and re-derives
    sigma by power iteration from the stored ``u``; we seed u with torch's
    converged vector and sigma = u . W_mat . v so the first normalised
    weight matches torch's exactly.
    """
    w = _np(sd[tpfx + "weight_orig"])
    u = _np(sd[tpfx + "weight_u"])
    v = _np(sd[tpfx + "weight_v"])
    w_mat = w.reshape(w.shape[0], -1)
    sigma = float(u @ w_mat @ v)
    params: Flat = {f"{fpfx}/Conv_0/kernel": conv2d_k(w)}
    if bias:
        params[f"{fpfx}/Conv_0/bias"] = _np(sd[tpfx + "bias"])
    stats: Flat = {
        f"{fpfx}/SpectralNorm_0/Conv_0/kernel/u": u.reshape(1, -1),
        f"{fpfx}/SpectralNorm_0/Conv_0/kernel/sigma": np.asarray(
            sigma, np.float32
        ),
    }
    return params, stats


def convert_mel_style_encoder(sd: Dict[str, np.ndarray]) -> Tuple[Flat, Flat]:
    """Reference MelStyleEncoder (mel_style_encoder.py:120-151) ->
    (params, batch_stats).  Sequential indices: 0 conv_in, 1-4 ResBlks,
    6 conv_out; unshared Linear."""
    params: Flat = {}
    stats: Flat = {}

    def add(tpfx, fpfx, bias=True):
        p, s = _spectral(sd, tpfx, fpfx, bias=bias)
        params.update(p)
        stats.update(s)

    add("shared.0.", "conv_in")
    for i in range(4):
        blk = f"shared.{i + 1}."
        add(blk + "conv1.", f"res_{i}/conv1")
        add(blk + "conv2.", f"res_{i}/conv2")
        if blk + "downsample_res.conv.weight_orig" in sd:
            add(blk + "downsample_res.conv.", f"res_{i}/downconv")
        if blk + "conv1x1.weight_orig" in sd:
            add(blk + "conv1x1.", f"res_{i}/conv1x1", bias=False)
    add("shared.6.", "conv_out")
    params["unshared/kernel"] = linear_k(sd["unshared.weight"])
    params["unshared/bias"] = _np(sd["unshared.bias"])
    return params, stats


def _adaln(sd: Dict[str, np.ndarray], prefix: str) -> Flat:
    return {
        "fc/kernel": linear_k(sd[f"{prefix}fc.weight"]),
        "fc/bias": _np(sd[f"{prefix}fc.bias"]),
    }


def convert_prosody_encoder(sd: Dict[str, np.ndarray]) -> Flat:
    """Reference ProsodyEncoder (prosody_encoder.py:10-81)."""
    out: Flat = {}
    n_layers = max(int(k.split(".")[1]) + 1 for k in sd if k.startswith("attn_layers."))
    for i in range(n_layers):
        out.update(_prefixed(f"attn_{i}", _mha(sd, f"attn_layers.{i}.")))
        out.update(_prefixed(f"ffn_{i}", _ffn(sd, f"ffn_layers.{i}.")))
        out.update(_prefixed(f"norm1_{i}", _adaln(sd, f"norm_layers_1.{i}.")))
        out.update(_prefixed(f"norm2_{i}", _adaln(sd, f"norm_layers_2.{i}.")))
        out[f"proj_{i}/kernel"] = conv1d_k(sd[f"proj_layers.{i}.weight"])
        out[f"proj_{i}/bias"] = _np(sd[f"proj_layers.{i}.bias"])
    return out


def convert_duration_predictor(sd: Dict[str, np.ndarray]) -> Flat:
    """Reference DurationPredictor (duration_predictor.py:8-36)."""
    sd = fold_weight_norm(sd)
    out: Flat = {}
    out.update(_prefixed("text_encoder", convert_text_encoder(_sub(sd, "text_encoder."))))
    out.update(
        _prefixed(
            "style_encoder", convert_text_style_encoder(_sub(sd, "style_encoder."))
        )
    )
    out.update(
        _prefixed(
            "prosody_encoder", convert_prosody_encoder(_sub(sd, "prosody_encoder."))
        )
    )
    out["duration_proj/kernel"] = linear_k(sd["duration_proj.linear_layer.weight"])
    out["duration_proj/bias"] = _np(sd["duration_proj.linear_layer.bias"])
    return out


def _adain_res_block(sd: Dict[str, np.ndarray], prefix: str) -> Flat:
    """Reference AdaptiveDecoderBlock (ada_norm.py:142-182), weight norms
    already folded."""
    out: Flat = {
        "conv1/Conv_0/kernel": conv1d_k(sd[f"{prefix}conv1.weight"]),
        "conv1/Conv_0/bias": _np(sd[f"{prefix}conv1.bias"]),
        "conv2/Conv_0/kernel": conv1d_k(sd[f"{prefix}conv2.weight"]),
        "conv2/Conv_0/bias": _np(sd[f"{prefix}conv2.bias"]),
    }
    out.update(_prefixed("AdaptiveInstanceNorm_0", _adaln(sd, f"{prefix}norm1.")))
    out.update(_prefixed("AdaptiveInstanceNorm_1", _adaln(sd, f"{prefix}norm2.")))
    if f"{prefix}conv1x1.weight" in sd:
        out["conv1x1/kernel"] = conv1d_k(sd[f"{prefix}conv1x1.weight"])
    return out


def convert_pitch_energy_predictor(sd: Dict[str, np.ndarray]) -> Flat:
    """Reference PitchEnergyPredictor (pitch_energy_predictor.py:11-121)."""
    sd = fold_weight_norm(sd)
    out: Flat = {}
    out.update(
        _prefixed(
            "prosody_encoder", convert_prosody_encoder(_sub(sd, "prosody_encoder."))
        )
    )
    out.update(_prefixed("query_norm", _adaln(sd, "query_norm.")))
    out.update(_prefixed("key_norm", _adaln(sd, "key_norm.")))
    out.update(_prefixed("cross_attention", _mha(sd, "cross_attention.")))
    out["cross_post_dw/Conv_0/kernel"] = conv1d_k(sd["cross_post.0.weight"])
    out["cross_post_dw/Conv_0/bias"] = _np(sd["cross_post.0.bias"])
    out["cross_post_pw/kernel"] = conv1d_k(sd["cross_post.2.weight"])
    out["cross_post_pw/bias"] = _np(sd["cross_post.2.bias"])
    for tname, fname in (("F0", "f0_block"), ("N", "energy_block")):
        for i in range(3):
            out.update(
                _prefixed(f"{fname}_{i}", _adain_res_block(sd, f"{tname}.{i}."))
            )
    out["f0_proj/kernel"] = conv1d_k(sd["F0_proj.weight"])
    out["f0_proj/bias"] = _np(sd["F0_proj.bias"])
    out["energy_proj/kernel"] = conv1d_k(sd["N_proj.weight"])
    out["energy_proj/bias"] = _np(sd["N_proj.bias"])
    return out


def convert_decoder(sd: Dict[str, np.ndarray]) -> Flat:
    """Reference Decoder (decoder.py:6-61), weight norms already folded."""
    out: Flat = {
        "f0_conv/Conv_0/kernel": conv1d_k(sd["F0_conv.weight"]),
        "f0_conv/Conv_0/bias": _np(sd["F0_conv.bias"]),
        "n_conv/Conv_0/kernel": conv1d_k(sd["N_conv.weight"]),
        "n_conv/Conv_0/bias": _np(sd["N_conv.bias"]),
        "asr_res/kernel": conv1d_k(sd["asr_res.0.weight"]),
        "asr_res/bias": _np(sd["asr_res.0.bias"]),
    }
    out.update(_prefixed("encode", _adain_res_block(sd, "encode.")))
    for i in range(4):
        out.update(_prefixed(f"decode_{i}", _adain_res_block(sd, f"decode.{i}.")))
    return out


def _wavenet(sd: Dict[str, np.ndarray], prefix: str, n_layers: int) -> Flat:
    """Reference WN (flow.py:17-96): weight-normed convs (in_layers) +
    Linears (res_skip, cond), already folded."""
    out: Flat = {}
    for i in range(n_layers):
        out[f"in_{i}/Conv_0/kernel"] = conv1d_k(sd[f"{prefix}in_layers.{i}.weight"])
        out[f"in_{i}/Conv_0/bias"] = _np(sd[f"{prefix}in_layers.{i}.bias"])
        out[f"res_skip_{i}/kernel"] = linear_k(sd[f"{prefix}res_skip_layers.{i}.weight"])
        out[f"res_skip_{i}/bias"] = _np(sd[f"{prefix}res_skip_layers.{i}.bias"])
    if f"{prefix}cond_layer.weight" in sd:
        out["cond_layer/kernel"] = linear_k(sd[f"{prefix}cond_layer.weight"])
        out["cond_layer/bias"] = _np(sd[f"{prefix}cond_layer.bias"])
    return out


def convert_flow(sd: Dict[str, np.ndarray], n_flows: int = 8, n_layers: int = 4) -> Flat:
    """Reference ResidualCouplingBlock (flow.py:99-151): couplings live at
    even Sequential indices (odd ones are parameterless Flips)."""
    out: Flat = {}
    for i in range(n_flows):
        p = f"flows.{2 * i}."
        out[f"flow_{i}/pre/kernel"] = linear_k(sd[p + "pre.weight"])
        out[f"flow_{i}/pre/bias"] = _np(sd[p + "pre.bias"])
        out.update(_prefixed(f"flow_{i}/enc", _wavenet(sd, p + "enc.", n_layers)))
        for head in ("proj_mean", "proj_logstd"):
            out[f"flow_{i}/{head}/kernel"] = linear_k(sd[p + head + ".weight"])
            out[f"flow_{i}/{head}/bias"] = _np(sd[p + head + ".bias"])
    return out


def convert_posterior_encoder(sd: Dict[str, np.ndarray], n_layers: int = 12) -> Flat:
    out: Flat = {
        "pre_spec/kernel": conv1d_k(sd["pre_spec.weight"]),
        "pre_spec/bias": _np(sd["pre_spec.bias"]),
        "pre_phase/kernel": conv1d_k(sd["pre_phase.weight"]),
        "pre_phase/bias": _np(sd["pre_phase.bias"]),
    }
    out.update(_prefixed("enc", _wavenet(sd, "enc.", n_layers)))
    for head in ("proj_mean", "proj_logstd"):
        out[f"{head}/kernel"] = linear_k(sd[head + ".weight"])
        out[f"{head}/bias"] = _np(sd[head + ".bias"])
    return out


def convert_generator(sd: Dict[str, np.ndarray]) -> Flat:
    """Reference freegan Generator (generator.py:340-438)."""
    out: Flat = {
        "projector/kernel": conv1d_k(sd["projector.weight"]),
        "projector/bias": _np(sd["projector.bias"]),
    }
    for tn, fn in (
        ("amp_prior_conv", "amp_prior_conv"),
        ("phase_prior_conv", "phase_prior_conv"),
        ("amp_output_conv", "amp_output_conv"),
        ("phase_output_conv", "phase_output_conv"),
    ):
        out[f"{fn}/Conv_0/kernel"] = conv1d_k(sd[f"{tn}.weight"])
        out[f"{fn}/Conv_0/bias"] = _np(sd[f"{tn}.bias"])
    n_blocks = max(int(k.split(".")[1]) + 1 for k in sd if k.startswith("convnext."))
    for i in range(n_blocks):
        p = f"convnext.{i}."
        out[f"convnext_{i}/dwconv/Conv_0/kernel"] = conv1d_k(sd[p + "dwconv.weight"])
        out[f"convnext_{i}/dwconv/Conv_0/bias"] = _np(sd[p + "dwconv.bias"])
        out.update(
            _prefixed(f"convnext_{i}/AdaptiveLayerNorm_0", _adaln(sd, p + "norm."))
        )
        out[f"convnext_{i}/pwconv1/kernel"] = linear_k(sd[p + "pwconv1.weight"])
        out[f"convnext_{i}/pwconv1/bias"] = _np(sd[p + "pwconv1.bias"])
        out[f"convnext_{i}/GRN_0/gamma"] = _np(sd[p + "grn.gamma"])
        out[f"convnext_{i}/GRN_0/beta"] = _np(sd[p + "grn.beta"])
        out[f"convnext_{i}/pwconv2/kernel"] = linear_k(sd[p + "pwconv2.weight"])
        out[f"convnext_{i}/pwconv2/bias"] = _np(sd[p + "pwconv2.bias"])
    for tn, fn in (
        ("amp_final_layer_norm", "amp_final_norm"),
        ("phase_final_layer_norm", "phase_final_norm"),
    ):
        out.update(_prefixed(fn, _adaln(sd, tn + ".")))
    return out


def convert_speech_predictor(sd: Dict[str, np.ndarray]) -> Flat:
    """Reference SpeechPredictor (speech_predictor.py:14-129)."""
    sd = fold_weight_norm(sd)
    out: Flat = {}
    out.update(_prefixed("text_encoder", convert_text_encoder(_sub(sd, "text_encoder."))))
    out.update(
        _prefixed(
            "style_encoder", convert_text_style_encoder(_sub(sd, "style_encoder."))
        )
    )
    out.update(_prefixed("decoder", convert_decoder(_sub(sd, "decoder."))))
    out.update(_prefixed("flow", convert_flow(_sub(sd, "flow."))))
    out.update(
        _prefixed(
            "posterior_encoder",
            convert_posterior_encoder(_sub(sd, "posterior_encoder.")),
        )
    )
    for head in ("proj_mean", "proj_logstd"):
        out[f"prior_encoder/{head}/kernel"] = linear_k(
            sd[f"prior_encoder.{head}.weight"]
        )
        out[f"prior_encoder/{head}/bias"] = _np(sd[f"prior_encoder.{head}.bias"])
    out["post_flow/kernel"] = linear_k(sd["post_flow.weight"])
    out["post_flow/bias"] = _np(sd["post_flow.bias"])
    out.update(_prefixed("generator", convert_generator(_sub(sd, "generator."))))
    return out


def _wn_conv2d(sd: Dict[str, np.ndarray], tpfx: str, fpfx: str, wn_idx: int,
               conv_name: str) -> Flat:
    """One weight-normed torch Conv2d -> flax nn.WeightNorm(nn.Conv):
    direction tensor as the kernel, g as the WeightNorm scale (both sides
    normalise over all axes but the feature one, torch dim=0)."""
    g = _np(sd[f"{tpfx}parametrizations.weight.original0"])
    v = _np(sd[f"{tpfx}parametrizations.weight.original1"])
    return {
        f"{conv_name}/kernel": conv2d_k(v),
        f"{conv_name}/bias": _np(sd[f"{tpfx}bias"]),
        f"WeightNorm_{wn_idx}/{conv_name}/kernel/scale": g.reshape(-1),
    }


def convert_mrd(sd: Dict[str, np.ndarray]) -> Flat:
    """Reference MultiResolutionDiscriminator (discriminator.py:31-99):
    3 SpecDiscriminators of 5 weight-normed convs + a 1-channel head."""
    out: Flat = {}
    n = max(int(k.split(".")[1]) + 1 for k in sd if k.startswith("discriminators."))
    for d in range(n):
        for i in range(5):
            out.update(
                _prefixed(
                    f"disc_{d}",
                    _wn_conv2d(
                        sd, f"discriminators.{d}.discriminators.{i}.", "", i,
                        f"conv_{i}",
                    ),
                )
            )
        out.update(
            _prefixed(
                f"disc_{d}",
                _wn_conv2d(sd, f"discriminators.{d}.out.", "", 5, "out"),
            )
        )
    return out


def convert_mpd(sd: Dict[str, np.ndarray],
                periods=(2, 3, 5, 7, 11)) -> Flat:
    """Reference MultiPeriodDiscriminator: per period, 5 weight-normed
    convs ``convs.{i}`` and the head ``conv_post``."""
    out: Flat = {}
    for d, p in enumerate(periods):
        for i in range(5):
            out.update(_prefixed(f"period_{p}", _wn_conv2d(
                sd, f"discriminators.{d}.convs.{i}.", "", i, f"conv_{i}")))
        out.update(_prefixed(f"period_{p}", _wn_conv2d(
            sd, f"discriminators.{d}.conv_post.", "", 5, "out")))
    return out


def convert_text_aligner(sd: Dict[str, np.ndarray]) -> Tuple[Flat, Flat]:
    """Reference CTC aligner (text_aligner.py:33-127): TDNN convs with
    affine-free BatchNorm + 5-layer FFN with skip -> (params, batch_stats)."""
    params: Flat = {}
    stats: Flat = {}
    for i in range(3):
        p = f"encoder.layers.{i}."
        params[f"tdnn_{i}/Conv_0/kernel"] = conv1d_k(sd[p + "0.weight"])
        params[f"tdnn_{i}/Conv_0/bias"] = _np(sd[p + "0.bias"])
        stats[f"bn_{i}/mean"] = _np(sd[p + "2.running_mean"])
        stats[f"bn_{i}/var"] = _np(sd[p + "2.running_var"])
    for j, idx in enumerate((0, 3, 6, 9, 12)):
        params[f"ffn_{j}/kernel"] = linear_k(sd[f"encoder.layers.3.ffn.{idx}.weight"])
        params[f"ffn_{j}/bias"] = _np(sd[f"encoder.layers.3.ffn.{idx}.bias"])
    params["out/kernel"] = linear_k(sd["encoder_output_layer.weight"])
    params["out/bias"] = _np(sd["encoder_output_layer.bias"])
    return params, stats


def convert_hubert_speech_predictor(sd: Dict[str, np.ndarray]) -> Flat:
    """Reference HubertSpeechPredictor (speech_predictor.py:132-251):
    SpeechPredictor with a HubertEncoder front end and an MLP style head
    over the speaker embedding."""
    sd = fold_weight_norm(sd)
    out: Flat = {}
    out.update(
        _prefixed(
            "phone_encoder", convert_hubert_encoder(_sub(sd, "phone_encoder."))
        )
    )
    for j, idx in enumerate((0, 3, 6)):
        out[f"style{j + 1}/kernel"] = linear_k(sd[f"style_encoder.{idx}.weight"])
        out[f"style{j + 1}/bias"] = _np(sd[f"style_encoder.{idx}.bias"])
    out.update(_prefixed("decoder", convert_decoder(_sub(sd, "decoder."))))
    out.update(_prefixed("flow", convert_flow(_sub(sd, "flow."))))
    out.update(
        _prefixed(
            "posterior_encoder",
            convert_posterior_encoder(_sub(sd, "posterior_encoder.")),
        )
    )
    for head in ("proj_mean", "proj_logstd"):
        out[f"prior_encoder/{head}/kernel"] = linear_k(
            sd[f"prior_encoder.{head}.weight"]
        )
        out[f"prior_encoder/{head}/bias"] = _np(sd[f"prior_encoder.{head}.bias"])
    out["post_flow/kernel"] = linear_k(sd["post_flow.weight"])
    out["post_flow/bias"] = _np(sd["post_flow.bias"])
    out.update(_prefixed("generator", convert_generator(_sub(sd, "generator."))))
    return out


def convert_hubert_pitch_energy_predictor(sd: Dict[str, np.ndarray]) -> Flat:
    """Reference HubertPitchEnergyPredictor
    (pitch_energy_predictor.py:124-191)."""
    sd = fold_weight_norm(sd)
    out: Flat = {
        "phone_quant/kernel": conv1d_k(sd["phone_quant.weight"]),
        "phone_quant/bias": _np(sd["phone_quant.bias"]),
        "style_encoder/kernel": linear_k(sd["style_encoder.weight"]),
        "style_encoder/bias": _np(sd["style_encoder.bias"]),
    }
    out.update(
        _prefixed(
            "prosody_encoder", convert_prosody_encoder(_sub(sd, "prosody_encoder."))
        )
    )
    for tname, fname in (("F0", "f0_block"), ("N", "energy_block")):
        for i in range(3):
            out.update(
                _prefixed(f"{fname}_{i}", _adain_res_block(sd, f"{tname}.{i}."))
            )
    out["f0_proj/kernel"] = conv1d_k(sd["F0_proj.weight"])
    out["f0_proj/bias"] = _np(sd["F0_proj.bias"])
    out["energy_proj/kernel"] = conv1d_k(sd["N_proj.weight"])
    out["energy_proj/bias"] = _np(sd["N_proj.bias"])
    return out


def _style_convnext(sd: Dict[str, np.ndarray], tpfx: str) -> Flat:
    """Style-conditioned ConvNeXt block (generator.py:441-499)."""
    out: Flat = {
        "dwconv/Conv_0/kernel": conv1d_k(sd[f"{tpfx}dwconv.weight"]),
        "dwconv/Conv_0/bias": _np(sd[f"{tpfx}dwconv.bias"]),
        "pwconv1/kernel": linear_k(sd[f"{tpfx}pwconv1.weight"]),
        "pwconv1/bias": _np(sd[f"{tpfx}pwconv1.bias"]),
        "GRN_0/gamma": _np(sd[f"{tpfx}grn.gamma"]),
        "GRN_0/beta": _np(sd[f"{tpfx}grn.beta"]),
        "pwconv2/kernel": linear_k(sd[f"{tpfx}pwconv2.weight"]),
        "pwconv2/bias": _np(sd[f"{tpfx}pwconv2.bias"]),
    }
    out.update(_prefixed("AdaptiveLayerNorm_0", _adaln(sd, f"{tpfx}norm.")))
    return out


def convert_cfm_pitch_predictor(sd: Dict[str, np.ndarray]) -> Tuple[Flat, Flat]:
    """Reference CfmPitchPredictor (cfm/cfm_pitch_predictor.py:12-53):
    conv embeds + MelStyleEncoder speaker branch + 4 style-ConvNeXt
    blocks.  The unused ``in_proj`` is dropped."""
    out: Flat = {
        "asr_emb1/kernel": conv1d_k(sd["asr_emb.0.weight"]),
        "asr_emb1/bias": _np(sd["asr_emb.0.bias"]),
        "asr_emb2/kernel": conv1d_k(sd["asr_emb.2.weight"]),
        "asr_emb2/bias": _np(sd["asr_emb.2.bias"]),
        "out_proj/kernel": conv1d_k(sd["out_proj.weight"]),
        "out_proj/bias": _np(sd["out_proj.bias"]),
    }
    spk_params, spk_stats = convert_mel_style_encoder(_sub(sd, "spk_emb."))
    out.update(_prefixed("spk_emb", spk_params))
    for i in range(4):
        out.update(_prefixed(f"block_{i}", _style_convnext(sd, f"blocks.{i}.")))
    return out, _prefixed("spk_emb", spk_stats)


def _xut_block(sd: Dict[str, np.ndarray], tpfx: str) -> Flat:
    """One XUT TransformerBlock (xut/transformer.py:9-81) with fused qkv,
    learnable axial-RoPE freqs, packed SwiGLU and RMSNorm pre-norms."""
    out: Flat = {
        "attn/qkv/kernel": linear_k(sd[f"{tpfx}attn.qkv.weight"]),
        "attn/out/kernel": linear_k(sd[f"{tpfx}attn.out.weight"]),
        "attn/out/bias": _np(sd[f"{tpfx}attn.out.bias"]),
        "attn/rope/freqs": _np(sd[f"{tpfx}attn.rope.freqs"]),
        "mlp/w12/kernel": linear_k(sd[f"{tpfx}mlp.w12.weight"]),
        "mlp/w12/bias": _np(sd[f"{tpfx}mlp.w12.bias"]),
        "mlp/w3/kernel": linear_k(sd[f"{tpfx}mlp.w3.weight"]),
        "mlp/w3/bias": _np(sd[f"{tpfx}mlp.w3.bias"]),
        "attn_pre_norm/norm/scale": _np(sd[f"{tpfx}attn_pre_norm.norm.weight"]),
        "mlp_pre_norm/norm/scale": _np(sd[f"{tpfx}mlp_pre_norm.norm.weight"]),
    }
    if f"{tpfx}xattn.q.weight" in sd:
        out["xattn/q/kernel"] = linear_k(sd[f"{tpfx}xattn.q.weight"])
        out["xattn/kv/kernel"] = linear_k(sd[f"{tpfx}xattn.kv.weight"])
        out["xattn/out/kernel"] = linear_k(sd[f"{tpfx}xattn.out.weight"])
        out["xattn/out/bias"] = _np(sd[f"{tpfx}xattn.out.bias"])
        out["xattn/rope/freqs"] = _np(sd[f"{tpfx}xattn.rope.freqs"])
        out["xattn_pre_norm/norm/scale"] = _np(
            sd[f"{tpfx}xattn_pre_norm.norm.weight"]
        )
    return out


def _shared_adaln(sd: Dict[str, np.ndarray], tpfx: str) -> Flat:
    """Shared AdaLN head Sequential (LayerNorm, Linear, Mish, Linear)."""
    return {
        "ln/scale": _np(sd[f"{tpfx}0.weight"]),
        "ln/bias": _np(sd[f"{tpfx}0.bias"]),
        "fc1/kernel": linear_k(sd[f"{tpfx}1.weight"]),
        "fc1/bias": _np(sd[f"{tpfx}1.bias"]),
        "fc2/kernel": linear_k(sd[f"{tpfx}3.weight"]),
        "fc2/bias": _np(sd[f"{tpfx}3.bias"]),
    }


def convert_cfm_mel_decoder(sd: Dict[str, np.ndarray]) -> Flat:
    """Reference CfmMelDecoder (cfm/cfm_mel_decoder.py:193-418): XUT
    backbone + TREAD routers + sine source + shared AdaLN heads.  The
    ``time_emb.freqs`` entry is a deterministic buffer (time_emb.py)
    reproduced in closed form on our side."""
    out: Flat = {
        "time_emb/proj/kernel": linear_k(sd["time_emb.proj.0.weight"]),
        "time_emb/proj/bias": _np(sd["time_emb.proj.0.bias"]),
        "asr_emb1/kernel": linear_k(sd["asr_emb.1.weight"]),
        "asr_emb1/bias": _np(sd["asr_emb.1.bias"]),
        "asr_emb2/kernel": linear_k(sd["asr_emb.3.weight"]),
        "asr_emb2/bias": _np(sd["asr_emb.3.bias"]),
        "spk_emb1/kernel": linear_k(sd["spk_emb.0.weight"]),
        "spk_emb1/bias": _np(sd["spk_emb.0.bias"]),
        "spk_emb2/kernel": linear_k(sd["spk_emb.2.weight"]),
        "spk_emb2/bias": _np(sd["spk_emb.2.bias"]),
        "m_source/merge/kernel": linear_k(sd["m_source.1.merge.0.weight"]),
        "prior_generator/kernel": conv1d_k(sd["prior_generator.1.weight"]),
        "prior_generator/bias": _np(sd["prior_generator.1.bias"]),
        "in_proj/kernel": linear_k(sd["in_proj.weight"]),
        "in_proj/bias": _np(sd["in_proj.bias"]),
        "out_proj/kernel": linear_k(sd["out_proj.0.weight"]),
        "out_proj/bias": _np(sd["out_proj.0.bias"]),
    }
    for tn, fn in (
        ("shared_adaln_attn.", "shared_attn"),
        ("shared_adaln_xattn.", "shared_xattn"),
        ("shared_adaln_ffw.", "shared_ffw"),
    ):
        out.update(_prefixed(fn, _shared_adaln(sd, tn)))
    depth = max(
        int(k.split(".")[2]) + 1 for k in sd if k.startswith("backbone.enc_blocks.")
    )
    for d in range(depth):
        for i in (0, 1, 2, 3):
            tp = f"backbone.enc_blocks.{d}.{i}."
            if f"{tp}attn.qkv.weight" in sd:
                out.update(_prefixed(f"backbone/enc_{d}_{i}", _xut_block(sd, tp)))
            tp = f"backbone.dec_blocks.{d}.{i}."
            if f"{tp}attn.qkv.weight" in sd:
                out.update(_prefixed(f"backbone/dec_{d}_{i}", _xut_block(sd, tp)))
    for tn, fn in (
        ("prev_tread_trns.blocks.", "prev_tread/block_"),
        ("post_tread_trns.blocks.", "post_tread/block_"),
    ):
        i = 0
        while f"{tn}{i}.attn.qkv.weight" in sd:
            out.update(_prefixed(f"{fn}{i}", _xut_block(sd, f"{tn}{i}.")))
            i += 1
    return out


def _bn2d(sd: Dict[str, np.ndarray], tpfx: str, fpfx: str) -> Tuple[Flat, Flat]:
    params = {
        f"{fpfx}/scale": _np(sd[f"{tpfx}.weight"]),
        f"{fpfx}/bias": _np(sd[f"{tpfx}.bias"]),
    }
    stats = {
        f"{fpfx}/mean": _np(sd[f"{tpfx}.running_mean"]),
        f"{fpfx}/var": _np(sd[f"{tpfx}.running_var"]),
    }
    return params, stats


def _conv_block_res(sd: Dict[str, np.ndarray], tpfx: str) -> Tuple[Flat, Flat]:
    """RMVPE ConvBlockRes (rmvpe/deepunet.py:6-42): Sequential indices
    0/3 convs (bias-free), 1/4 BNs, optional 1x1 shortcut."""
    params: Flat = {}
    stats: Flat = {}
    for j, idx in enumerate((0, 3)):
        params[f"conv_{j}/kernel"] = conv2d_k(sd[f"{tpfx}conv.{idx}.weight"])
        p, s = _bn2d(sd, f"{tpfx}conv.{idx + 1}", f"bn_{j}")
        params.update(p)
        stats.update(s)
    if f"{tpfx}shortcut.weight" in sd:
        params["shortcut/kernel"] = conv2d_k(sd[f"{tpfx}shortcut.weight"])
        params["shortcut/bias"] = _np(sd[f"{tpfx}shortcut.bias"])
    return params, stats


def _gru_cell(sd: Dict[str, np.ndarray], sfx: str) -> Flat:
    """torch nn.GRU direction -> flax GRUCell params.  torch gate order is
    (reset, update, new) stacked in weight_ih/weight_hh; flax ir/iz have
    the only input-side bias, so b_ih + b_hh fold there; hn keeps its own
    bias (flax: n = tanh(in(x) + r*hn(h)))."""
    w_ih = _np(sd[f"weight_ih_l0{sfx}"])
    w_hh = _np(sd[f"weight_hh_l0{sfx}"])
    b_ih = _np(sd[f"bias_ih_l0{sfx}"])
    b_hh = _np(sd[f"bias_hh_l0{sfx}"])
    h = w_hh.shape[1]
    out: Flat = {}
    for g, name in enumerate(("r", "z", "n")):
        wi = w_ih[g * h:(g + 1) * h]
        wh = w_hh[g * h:(g + 1) * h]
        bi = b_ih[g * h:(g + 1) * h]
        bh = b_hh[g * h:(g + 1) * h]
        out[f"i{name}/kernel"] = linear_k(wi)
        out[f"h{name}/kernel"] = linear_k(wh)
        if name == "n":
            out["in/bias"] = bi
            out["hn/bias"] = bh
        else:
            out[f"i{name}/bias"] = bi + bh
    return out


def convert_rmvpe(sd: Dict[str, np.ndarray]) -> Tuple[Flat, Flat]:
    """Reference RMVPE E2E0(4, 1, (2, 2)) (rmvpe/model.py, deepunet.py,
    seq.py) -> dataprep.rmvpe.RMVPE params + batch_stats.  ConvTranspose
    kernels flip spatially (torch transpose-conv vs lax.conv_transpose)."""
    params: Flat = {}
    stats: Flat = {}

    def add(sub, fpfx):
        p, s = sub
        params.update(_prefixed(fpfx, p))
        stats.update(_prefixed(fpfx, s))

    add(_bn2d(sd, "unet.encoder.bn", "bn"), "in_bn")
    # _bn2d emits under <fpfx>/bn; flatten the in_bn naming
    for d in (params, stats):
        for k in list(d):
            if k.startswith("in_bn/bn/"):
                d["in_bn/" + k[len("in_bn/bn/"):]] = d.pop(k)

    n_enc = max(
        int(k.split(".")[3]) + 1 for k in sd if k.startswith("unet.encoder.layers.")
    )
    for i in range(n_enc):
        j = 0
        while f"unet.encoder.layers.{i}.conv.{j}.conv.0.weight" in sd:
            add(
                _conv_block_res(sd, f"unet.encoder.layers.{i}.conv.{j}."),
                f"enc_{i}/block_{j}",
            )
            j += 1
    n_int = max(
        int(k.split(".")[3]) + 1
        for k in sd
        if k.startswith("unet.intermediate.layers.")
    )
    for i in range(n_int):
        j = 0
        while f"unet.intermediate.layers.{i}.conv.{j}.conv.0.weight" in sd:
            add(
                _conv_block_res(sd, f"unet.intermediate.layers.{i}.conv.{j}."),
                f"inter_{i}/block_{j}",
            )
            j += 1
    n_dec = max(
        int(k.split(".")[3]) + 1 for k in sd if k.startswith("unet.decoder.layers.")
    )
    for i in range(n_dec):
        w = _np(sd[f"unet.decoder.layers.{i}.conv1.0.weight"])  # (in,out,kh,kw)
        params[f"dec_{i}/up/kernel"] = np.ascontiguousarray(
            np.flip(w, (2, 3)).transpose(2, 3, 0, 1)
        )
        add(_bn2d(sd, f"unet.decoder.layers.{i}.conv1.1", "bn"), f"dec_{i}")
        j = 0
        while f"unet.decoder.layers.{i}.conv2.{j}.conv.0.weight" in sd:
            add(
                _conv_block_res(sd, f"unet.decoder.layers.{i}.conv2.{j}."),
                f"dec_{i}/block_{j}",
            )
            j += 1
    params["cnn/kernel"] = conv2d_k(sd["cnn.weight"])
    params["cnn/bias"] = _np(sd["cnn.bias"])
    params.update(_prefixed("gru/fwd", _gru_cell(_sub(sd, "fc.0.gru."), "")))
    params.update(
        _prefixed("gru/bwd", _gru_cell(_sub(sd, "fc.0.gru."), "_reverse"))
    )
    params["head/kernel"] = linear_k(sd["fc.1.weight"])
    params["head/bias"] = _np(sd["fc.1.bias"])
    return params, stats


def _bn2(sd: Dict[str, np.ndarray], prefix: str) -> Flat:
    """torch BatchNorm(weight,bias,running_mean,running_var) -> the frozen
    FrozenBatchNorm params of models/wespeaker.py."""
    return {
        "scale": _np(sd[prefix + "weight"]),
        "bias": _np(sd[prefix + "bias"]),
        "mean": _np(sd[prefix + "running_mean"]),
        "var": _np(sd[prefix + "running_var"]),
    }


def convert_wespeaker(sd: Dict[str, np.ndarray]) -> Flat:
    """wespeaker vblinkp (voxblink2 SimAM-ResNet34 + ASP, reference
    train/models/ssl.py:34-67) -> models/wespeaker.py:SimAMResNet34ASP.
    Input: the raw speaker nn.Module state_dict (`model.model` in
    wespeaker's wrapper); the stripped bottleneck layer is ignored."""
    out: Flat = {
        "front/conv1/kernel": conv2d_k(sd["front.conv1.weight"]),
    }
    out.update(_prefixed("front/bn1", _bn2(sd, "front.bn1.")))
    layers = (3, 4, 6, 3)
    for s, blocks in enumerate(layers, start=1):
        for i in range(blocks):
            p = f"front.layer{s}.{i}."
            f = f"front/layer{s}_{i}"
            out[f"{f}/conv1/kernel"] = conv2d_k(sd[p + "conv1.weight"])
            out.update(_prefixed(f"{f}/bn1", _bn2(sd, p + "bn1.")))
            out[f"{f}/conv2/kernel"] = conv2d_k(sd[p + "conv2.weight"])
            out.update(_prefixed(f"{f}/bn2", _bn2(sd, p + "bn2.")))
            if p + "downsample.0.weight" in sd:
                out[f"{f}/downsample_conv/kernel"] = conv2d_k(
                    sd[p + "downsample.0.weight"]
                )
                out.update(
                    _prefixed(f"{f}/downsample_bn",
                              _bn2(sd, p + "downsample.1."))
                )
    out["pooling/att_in/kernel"] = conv1d_k(sd["pooling.attention.0.weight"])
    out["pooling/att_in/bias"] = _np(sd["pooling.attention.0.bias"])
    out.update(_prefixed("pooling/att_bn", _bn2(sd, "pooling.attention.2.")))
    out["pooling/att_out/kernel"] = conv1d_k(sd["pooling.attention.3.weight"])
    out["pooling/att_out/bias"] = _np(sd["pooling.attention.3.bias"])
    return out


def convert_vocos(sd: Dict[str, np.ndarray]) -> Flat:
    """Pretrained Vocos mel vocoder (charactr/vocos-mel-24khz; the reference
    loads it via Vocos.from_pretrained, train/train_context.py:179-183).
    Maps the `backbone.*` / `head.*` state_dict into models/vocos.py:Vocos;
    the mel feature extractor is weight-free and the iSTFT window is
    rebuilt on device, so those buffers are skipped."""
    out: Flat = {
        "embed/Conv_0/kernel": conv1d_k(sd["backbone.embed.weight"]),
        "embed/Conv_0/bias": _np(sd["backbone.embed.bias"]),
        "norm/scale": _np(sd["backbone.norm.weight"]),
        "norm/bias": _np(sd["backbone.norm.bias"]),
        "final_layer_norm/scale": _np(sd["backbone.final_layer_norm.weight"]),
        "final_layer_norm/bias": _np(sd["backbone.final_layer_norm.bias"]),
        "out/kernel": linear_k(sd["head.out.weight"]),
        "out/bias": _np(sd["head.out.bias"]),
    }
    n_blocks = max(
        int(k.split(".")[2]) + 1 for k in sd if k.startswith("backbone.convnext.")
    )
    for i in range(n_blocks):
        p = f"backbone.convnext.{i}."
        f = f"convnext_{i}"
        out[f"{f}/dwconv/Conv_0/kernel"] = conv1d_k(sd[p + "dwconv.weight"])
        out[f"{f}/dwconv/Conv_0/bias"] = _np(sd[p + "dwconv.bias"])
        out[f"{f}/norm/scale"] = _np(sd[p + "norm.weight"])
        out[f"{f}/norm/bias"] = _np(sd[p + "norm.bias"])
        out[f"{f}/pwconv1/kernel"] = linear_k(sd[p + "pwconv1.weight"])
        out[f"{f}/pwconv1/bias"] = _np(sd[p + "pwconv1.bias"])
        out[f"{f}/pwconv2/kernel"] = linear_k(sd[p + "pwconv2.weight"])
        out[f"{f}/pwconv2/bias"] = _np(sd[p + "pwconv2.bias"])
        out[f"{f}/gamma"] = _np(sd[p + "gamma"])
    return out



# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

#: model name -> converter, the JAX package's 16.  Values return either a
#: params Flat or a (params, batch_stats) tuple.  ``convert_rmvpe`` is not
#: among them: only ``scripts/convert_rmvpe.py`` reaches it, as in the JAX
#: package.
CONVERTERS = {
    "vocos": convert_vocos,
    "wespeaker": convert_wespeaker,
    "mrd": convert_mrd,
    "mpd": convert_mpd,
    "text_aligner": convert_text_aligner,
    "duration_predictor": convert_duration_predictor,
    "pitch_energy_predictor": convert_pitch_energy_predictor,
    "speech_predictor": convert_speech_predictor,
    "pe_text_encoder": convert_text_encoder,
    "hubert_encoder": convert_hubert_encoder,
    "cfm_mel_decoder": convert_cfm_mel_decoder,
    "cfm_pitch_predictor": convert_cfm_pitch_predictor,
    "hubert_speech_predictor": convert_hubert_speech_predictor,
    "hubert_pitch_energy_predictor": convert_hubert_pitch_energy_predictor,
    "pe_text_style_encoder": convert_text_style_encoder,
    "pe_mel_style_encoder": convert_mel_style_encoder,
}


def converter(name: str):
    """The converter of model ``name``; raises for an unknown model."""
    if name in CONVERTERS:
        return CONVERTERS[name]
    raise ValueError(f"unknown model {name!r}; one of {sorted(CONVERTERS)}")


def convert_module(name: str, state_dict) -> Tuple[Flat, Flat]:
    """Convert one reference module's state_dict -> (params, batch_stats)
    flat dicts keyed by flax paths."""
    convert = converter(name)
    sd = {k: _np(v) for k, v in state_dict.items()}
    result = convert(sd)
    if isinstance(result, tuple):
        return result
    return result, {}
