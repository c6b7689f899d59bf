"""Weights drawn from the seed on the device, in a few large calls.

Two rules, each the same for the program's models and the reference's
(the parameter names and shapes are the models' own):

- ``"init"``: the distributions of the port's flax initialisers
  (``train/init.py:init_params``), as a training run starts: truncated
  lecun-normal weights, zero biases and zero-initialised heads, unit norm
  scales, normal(dim^-0.5) embeddings;
- ``"speech"``: every parameter normal at a trained model's scale, and the
  four heads synthesis needs at trained levels (F0 of speech, small prior
  and flow heads, a log-amplitude below the final tanh's saturation), so
  that random weights give finite, audible speech (the rule of
  ``chip_smoke.py:seeded_models`` and ``speech_levels``).

Every value comes from one ``torch.rand`` over all leaves of a model,
mapped through the normal's inverse CDF, so the same seed gives the same
weights on the same device whatever else the process drew.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

ZERO_INIT = ("proj_mean", "proj_logstd", "prenet.proj", "adaln",
             "shared_attn.fc2", "shared_xattn.fc2", "shared_ffw.fc2")
_TRUNC_STD = 0.87962566103423978  # std of the normal truncated to [-2, 2]
_PHI_2 = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))  # Phi(2)


def _normal(u: torch.Tensor, truncated: bool) -> torch.Tensor:
    """Standard normal (truncated to [-2, 2]) from uniform [0, 1)."""
    if truncated:
        p = (1.0 - _PHI_2) + u * (2.0 * _PHI_2 - 1.0)
    else:
        p = u.clamp(1e-7, 1.0 - 1e-7)
    return math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0)


def _embedding_names(module: nn.Module):
    return {f"{n}.weight" for n, m in module.named_modules()
            if isinstance(m, nn.Embedding)}


@torch.no_grad()
def draw(module: nn.Module, rule: str, generator: torch.Generator,
         device: torch.device) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of ``module`` (whose tensors may sit on
    the meta device) as a tensor on ``device``, drawn by ``rule``."""
    params = list(module.named_parameters())
    total = sum(p.numel() for _, p in params)
    u = torch.rand(total, generator=generator, device=device)
    embeddings = _embedding_names(module)
    out, offset = {}, 0
    for name, p in params:
        leaf = name.rsplit(".", 1)[-1]
        piece = u[offset:offset + p.numel()].view(p.shape)
        offset += p.numel()
        out[name] = _leaf(name, leaf, p, piece, rule, embeddings)
    for name, b in module.named_buffers():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "u":
            g = torch.rand(b.shape, generator=generator, device=device)
            out[name] = _normal(g, False)
        elif leaf in ("sigma", "var"):
            out[name] = torch.ones(b.shape, device=device)
        else:
            out[name] = torch.zeros(b.shape, dtype=b.dtype, device=device)
    return out


def _leaf(name, leaf, p, u, rule, embeddings) -> torch.Tensor:
    if rule == "speech":
        normal = _normal(u, False)
        if leaf in ("gamma", "scale", "gru_rel_pos_const") or \
                leaf.startswith("alpha") or (leaf == "weight"
                                             and p.dim() == 1):
            # norm and weight-norm scales, snake's frequencies: about 1
            return 1.0 + 0.1 * normal
        if leaf == "weight":
            return normal / p[0].numel() ** 0.5
        return 0.1 * normal  # biases, betas, alphas, embeddings' kin
    if rule != "init":
        raise ValueError(f"unknown weight rule {rule!r}")
    if any(f"{z}." in name for z in ZERO_INIT) or leaf in ("bias", "beta"):
        return torch.zeros_like(u)
    if name in embeddings:
        return _normal(u, False) * p.shape[1] ** -0.5
    if leaf == "rel_attn_embed":
        return 0.02 * _normal(u, False)
    if leaf == "freqs":  # AxialRoPE [heads, half, pos_dim]
        line = torch.linspace(math.log(math.pi), math.log(5.0 * math.pi),
                              p.shape[-1], device=u.device)
        return line.expand(p.shape).clone()
    if leaf in ("scale", "gru_rel_pos_const") or leaf.startswith("alpha"):
        return torch.ones_like(u)
    if leaf == "gamma":
        return torch.full_like(u, 1.0 if p.dim() == 1 else 0.0)
    if leaf == "weight" and p.dim() == 1:
        return torch.ones_like(u)
    if leaf == "weight":
        std = (1.0 / p[0].numel()) ** 0.5 / _TRUNC_STD
        return _normal(u, True) * std
    raise ValueError(f"no initialiser for {name}")


@torch.no_grad()
def speech_levels(weights: Dict[str, Dict[str, torch.Tensor]],
                  n_flows: int) -> None:
    """The heads synthesis needs at a trained model's levels, in place on
    drawn ``weights`` (by model, then parameter name): F0 of speech (about
    30-350 Hz at 200 phonemes), an energy of a few units, small prior and
    flow heads (exp(logstd) would overflow past 88), and a log-amplitude
    below the final tanh's saturation (the ringformer's, below exp's
    overflow).  At ``chip_smoke.py``'s levels the
    F0 and energy grow with the text's length and the prior's logstd
    overflows at 120-200 phonemes."""
    pe = weights["pitch_energy_predictor"]
    pe["f0_proj.weight"].mul_(3.0)
    pe["f0_proj.bias"].add_(180.0)  # Hz
    pe["energy_proj.weight"].mul_(0.05)
    sp = weights["speech_predictor"]
    heads = ["prior_encoder"] + [f"flow.flow_{i}" for i in range(n_flows)]
    for head in heads:
        sp[f"{head}.proj_mean.weight"].mul_(0.01)
        sp[f"{head}.proj_logstd.weight"].mul_(0.01)
    amp = "generator.amp_output_conv.Conv_0.weight"  # freegan's head
    if amp in sp:
        sp[amp].mul_(0.1)
    post = "generator.conv_post.weight"  # the ringformer's: [log-amp; phase]
    if post in sp:
        sp[post][: sp[post].shape[0] // 2].mul_(0.1)
