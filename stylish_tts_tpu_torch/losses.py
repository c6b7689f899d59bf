"""Loss functions of the training stages.

Every reduction over the batch is the global batch's (``parallel/mesh.py``):
with one process the plain torch reduction, over R ranks the all-reduced
one, so a data-parallel step computes the losses of the whole batch.

  * spectral convergence over the 3 multi-resolution mel spectrograms
  * anti-wrapping differential phase loss and the magnitude/phase loss
  * the VITS KL losses of the normalizing flow
  * LSGAN + TPRLS discriminator/generator losses, feature matching x2 and
    the gap-aware discriminator LR multiplier
  * the class-distance-weighted duration cross entropy
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from .ops.stft_kernel import stft_forward
from .parallel import mesh

# --------------------------------------------------------------------------- #
# spectral losses


def spectral_convergence_loss(target: torch.Tensor, pred: torch.Tensor
                              ) -> torch.Tensor:
    return mesh.sum(torch.abs(target - pred)) \
        / (mesh.sum(torch.abs(target)) + 1e-6)


def multi_resolution_stft_loss(target_list: Sequence[torch.Tensor],
                               pred_list: Sequence[torch.Tensor]
                               ) -> torch.Tensor:
    loss = 0.0
    for target, pred in zip(target_list, pred_list):
        loss = loss + spectral_convergence_loss(target, pred)
    return loss / len(target_list)


def _anti_wrapping(phase_diff: torch.Tensor, weights: torch.Tensor
                   ) -> torch.Tensor:
    two_pi = 2.0 * math.pi
    return torch.abs(phase_diff - two_pi * torch.round(phase_diff / two_pi)) \
        * weights


def differential_phase_loss(pred: torch.Tensor, target: torch.Tensor
                            ) -> torch.Tensor:
    """Anti-wrapped phase, frequency-difference and time-difference losses
    with exponential frequency weights; pred/target [B, T, F].  The
    differences are prepend-style: column j pairs x[j] - x[j-1] (x[-1] = 0)
    with weight j."""
    freq_size = target.shape[-1]
    base = math.exp(math.log(2.5) / (freq_size // 2))
    weights = torch.pow(
        torch.tensor(base, dtype=torch.float32, device=pred.device),
        torch.arange(freq_size, dtype=torch.float32, device=pred.device))
    loss = mesh.mean(_anti_wrapping(pred - target, weights))
    zf = torch.zeros_like(pred[..., :1])
    loss = loss + mesh.mean(_anti_wrapping(
        torch.diff(pred, dim=-1, prepend=zf)
        - torch.diff(target, dim=-1, prepend=zf), weights))
    zt = torch.zeros_like(pred[:, :1])
    loss = loss + mesh.mean(_anti_wrapping(
        torch.diff(pred, dim=1, prepend=zt)
        - torch.diff(target, dim=1, prepend=zt), weights))
    return loss


def magphase_loss(pred_magnitude: torch.Tensor, pred_phase: torch.Tensor,
                  audio_gt: torch.Tensor, *, n_fft: int, hop_length: int,
                  win_length: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log-magnitude L1, phase) losses against the STFT of the ground
    truth at the generator head's resolution."""
    with torch.no_grad():
        real, imag = stft_forward(audio_gt, n_fft=n_fft,
                                  hop_length=hop_length,
                                  win_length=win_length)
    frames = min(pred_magnitude.shape[1], real.shape[1])
    pred_magnitude = pred_magnitude[:, :frames]
    pred_phase = pred_phase[:, :frames]
    real, imag = real[:, :frames], imag[:, :frames]
    target_mag = torch.sqrt(real * real + imag * imag + 1e-14) + 1e-14
    voiced = target_mag > 1e-3
    target_phase = torch.where(voiced, torch.atan2(imag, real), 0.0)
    pred_phase = torch.where(voiced, pred_phase, 0.0)
    mag_l = mesh.mean(torch.abs(pred_magnitude
                                 - torch.log(target_mag + 1e-9)))
    return mag_l, differential_phase_loss(pred_phase, target_phase)


# --------------------------------------------------------------------------- #
# flow / KL losses (channels-last [B, T, H]; mean over batch and time, sum
# over channels)


def kl_loss(z_p, logs_q, m_p, logs_p) -> torch.Tensor:
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * ((z_p - m_p) ** 2) * torch.exp(-2.0 * logs_p)
    return mesh.mean(torch.sum(kl, dim=-1))


def kl_loss_normal(m_q, logs_q, m_p, logs_p) -> torch.Tensor:
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * (torch.exp(2.0 * logs_q) + (m_q - m_p) ** 2) \
        * torch.exp(-2.0 * logs_p)
    return mesh.mean(torch.sum(kl, dim=-1))


def normalizing_flow_losses(pred) -> Dict[str, torch.Tensor]:
    """kl_text / kl_audio from a prediction carrying the flow stats."""
    _, mean_text, logstd_text = pred.text_stats
    _, mean_text2mel, logstd_text2mel = pred.text2mel_stats
    _, mean_mel, logstd_mel = pred.mel_stats
    z_mel2text, _, logstd_mel2text = pred.mel2text_stats
    return {
        "kl_text": kl_loss(z_mel2text, logstd_mel2text, mean_text,
                           logstd_text),
        "kl_audio": kl_loss_normal(mean_text2mel, logstd_text2mel, mean_mel,
                                   logstd_mel),
    }


# --------------------------------------------------------------------------- #
# GAN losses


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(values * mask) / (torch.sum(mask) + 1e-9)


def _tprls(real_score: torch.Tensor, gen_score: torch.Tensor
           ) -> torch.Tensor:
    """Truncated pointwise relativistic LS term over the global batch's
    scores.  The median of an even count is the mean of the two middle
    values (``torch.median`` would return the lower one)."""
    tau = 0.04
    diff = mesh.gather(real_score - gen_score)
    m_dg = torch.quantile(diff.reshape(-1), 0.5)
    mask = (diff < m_dg).to(real_score.dtype)
    l_rel = _masked_mean((diff - m_dg) ** 2, mask)
    return tau - F.relu(tau - l_rel)


def discriminator_loss(real_scores: Sequence[torch.Tensor],
                       gen_scores: Sequence[torch.Tensor]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(total including TPRLS, the plain LSGAN part for the EMA)."""
    disc = 0.0
    tprls = 0.0
    for dr, dg in zip(real_scores, gen_scores):
        disc = disc + mesh.mean((1.0 - dr) ** 2) + mesh.mean(dg ** 2)
        tprls = tprls + _tprls(dr, dg)
    return disc + tprls, disc


def generator_adversarial_loss(real_scores, gen_scores, real_features,
                               gen_features) -> torch.Tensor:
    """Feature matching x2 + LSGAN + TPRLS (roles swapped on this side)."""
    feature = 0.0
    for fr, fg in zip(real_features, gen_features):
        for rl, gl in zip(fr, fg):
            feature = feature + mesh.mean(torch.abs(rl - gl))
    feature = feature * 2.0
    gen = 0.0
    for dg in gen_scores:
        gen = gen + mesh.mean((1.0 - dg) ** 2)
    tprls = 0.0
    for dr, dg in zip(real_scores, gen_scores):
        tprls = tprls + _tprls(dg, dr)
    return feature + gen + tprls


def disc_lr_multiplier(last_loss: torch.Tensor, sub_count: int = 3,
                       f_max: float = 4.0, h_min: float = 0.01
                       ) -> torch.Tensor:
    """Gap-aware discriminator LR multiplier from the EMA of the plain
    LSGAN discriminator loss."""
    ideal = 0.5 * sub_count
    x_max = 0.05 * sub_count
    x = torch.abs(last_loss - ideal)
    hi = ideal + ideal * x_max
    lo = ideal - ideal * x_max
    pow_up = torch.clamp(torch.pow(f_max, x / x_max), max=f_max)
    pow_down = torch.clamp(torch.pow(h_min, x / x_max), min=h_min)
    return torch.where(
        last_loss > hi, f_max,
        torch.where(last_loss < lo, h_min,
                    torch.where(last_loss > ideal, pow_up, pow_down)))


# --------------------------------------------------------------------------- #
# duration loss (class-distance-weighted cross entropy)


def duration_loss(pred: torch.Tensor, target: torch.Tensor,
                  text_lengths: torch.Tensor, class_weight: torch.Tensor,
                  alpha: float = 2.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ce, cdw): pred [B, T, C] logits, target [B, T] class ids,
    batch-averaged with per-sample length masking."""
    _, t, c = pred.shape
    classes = torch.arange(c, device=pred.device)
    distance = torch.abs(classes[None, :] - classes[:, None])
    distance = torch.clamp(distance, max=7).to(torch.float32) ** alpha
    valid = (torch.arange(t, device=pred.device)[None, :]
             < text_lengths[:, None]).to(torch.float32)
    log_probs = torch.log_softmax(pred, dim=-1)
    tgt_logp = torch.gather(log_probs, -1, target[..., None])[..., 0]
    w = class_weight[target] * valid
    w_norm = w / (torch.sum(w, dim=1, keepdim=True) + 1e-9)
    ce = -torch.sum(tgt_logp * w_norm, dim=1)
    d = distance[target]
    d = d / (torch.sum(d, dim=-1, keepdim=True) + 1e-9)
    cdw_terms = torch.log(1.0 - torch.softmax(pred, dim=-1) + 1e-9) * d
    denom = torch.clamp(text_lengths.to(torch.float32), min=1.0)
    cdw = -torch.sum(cdw_terms.sum(-1) * valid, dim=1) / denom * 100.0
    return mesh.mean(ce), mesh.mean(cdw)


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   beta: float = 1.0) -> torch.Tensor:
    diff = torch.abs(pred - target)
    return mesh.mean(torch.where(diff < beta, 0.5 * diff * diff / beta,
                                  diff - 0.5 * beta))
