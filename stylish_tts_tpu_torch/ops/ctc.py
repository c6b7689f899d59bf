"""CTC loss with label priors and Viterbi forced alignment in torch ops
(the JAX package's ``ops/ctc.py``).

Both run over time on the lattice of extended targets ``b t1 b t2 ... tL
b`` ([B, S = 2L + 1] states): the loss as a log-semiring forward
recursion, whose gradient autograd takes; the alignment as a
max-semiring recursion with back-pointers and a backtrace.  A frame at or
past a sequence's input length leaves its states where they were.

``torch.nn.functional.ctc_loss`` is not used: its native backward returns
``exp(log_probs) - posterior``, the gradient with respect to the logits
of a ``log_softmax`` that comes directly before it, and so is wrong once
label priors are subtracted after the ``log_softmax``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..parallel import mesh

NEG_INF = -1e30
PRIOR_SCALE = 0.3  # weight of the label priors subtracted from the emissions
PRIOR_FLOOR = -12.0  # least log prior an epoch's end sets


def _extend_targets(targets: torch.Tensor, blank: int) -> torch.Tensor:
    """[B, L] -> [B, 2L + 1] with blanks interleaved."""
    b, l = targets.shape
    ext = torch.full((b, 2 * l + 1), blank, dtype=torch.int64,
                     device=targets.device)
    ext[:, 1::2] = targets.long()
    return ext


def _shift(x: torch.Tensor, k: int) -> torch.Tensor:
    """x[:, s - k] at s, NEG_INF where s < k."""
    pad = torch.full_like(x[:, :k], NEG_INF)
    return torch.cat([pad, x[:, :-k]], dim=1)


def _lattice(log_probs, targets, blank):
    """(emission score of each state at each frame [B, T, S], the skip
    transition s-2 -> s allowed [B, S])."""
    ext = _extend_targets(targets, blank)
    b, t, _ = log_probs.shape
    emit = torch.gather(log_probs, 2,
                        ext[:, None, :].expand(b, t, ext.shape[1]))
    prev2 = torch.cat([torch.full_like(ext[:, :2], blank), ext[:, :-2]],
                      dim=1)[:, : ext.shape[1]]
    allow2 = (ext != blank) & (ext != prev2)
    return ext, emit, allow2


def _alpha0(emit: torch.Tensor) -> torch.Tensor:
    alpha = torch.full_like(emit[:, 0], NEG_INF)
    alpha = torch.cat([emit[:, 0, :2], alpha[:, 2:]], dim=1)
    return alpha


def _final(alpha: torch.Tensor, target_lengths: torch.Tensor):
    last = 2 * target_lengths.long()
    a_last = alpha.gather(1, last[:, None])[:, 0]
    a_prev = alpha.gather(1, torch.clamp(last - 1, min=0)[:, None])[:, 0]
    return last, a_last, a_prev


def _nll(log_probs, targets, input_lengths, target_lengths, blank):
    """Each sequence's negative log-likelihood of its CTC lattice [B]."""
    _, emit, allow2 = _lattice(log_probs, targets, blank)
    alpha = _alpha0(emit)
    for t in range(1, emit.shape[1]):
        a2 = torch.where(allow2, _shift(alpha, 2), NEG_INF)
        new = torch.logsumexp(torch.stack([alpha, _shift(alpha, 1), a2]),
                              dim=0) + emit[:, t]
        alpha = torch.where((t < input_lengths)[:, None], new, alpha)
    _, a_last, a_prev = _final(alpha, target_lengths)
    return -torch.logaddexp(a_last, a_prev)


def ctc_loss(
    log_probs: torch.Tensor,       # [B, T, C] log-softmaxed emissions
    targets: torch.Tensor,         # [B, L] label ids (padded)
    input_lengths: torch.Tensor,   # [B]
    target_lengths: torch.Tensor,  # [B]
    blank: int,
) -> torch.Tensor:
    """Negative log-likelihood of the CTC lattice, each sequence's divided
    by its target length, averaged over the (global) batch."""
    nll = _nll(log_probs, targets, input_lengths, target_lengths, blank)
    return mesh.mean(nll / torch.clamp(target_lengths, min=1))


def ctc_loss_with_priors(
    log_probs: torch.Tensor,
    targets: torch.Tensor,
    input_lengths: torch.Tensor,
    target_lengths: torch.Tensor,
    blank: int,
    log_priors: torch.Tensor,      # [C]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CTC loss of ``log_probs - PRIOR_SCALE * log_priors``; returns
    (loss, this batch's log-sum of the emissions over its valid frames
    [C], its frame count), the last two detached: they accumulate the
    epoch's label priors."""
    t = log_probs.shape[1]
    with torch.no_grad():
        valid = (torch.arange(t, device=log_probs.device)[None, :]
                 < input_lengths[:, None])[..., None]
        masked = torch.where(valid, log_probs, NEG_INF)
        batch_prior_sum = torch.logsumexp(masked.reshape(-1, masked.shape[-1]),
                                          dim=0)
        n_frames = input_lengths.sum()
    log_probs = log_probs - log_priors[None, None, :] * PRIOR_SCALE
    loss = ctc_loss(log_probs, targets, input_lengths, target_lengths, blank)
    return loss, batch_prior_sum, n_frames


def update_log_priors(log_prior_sum: torch.Tensor,
                      log_n_frames: torch.Tensor) -> torch.Tensor:
    """Epoch-end prior update: normalise and clamp at PRIOR_FLOOR."""
    return torch.clamp(log_prior_sum - log_n_frames, min=PRIOR_FLOOR)


@torch.no_grad()
def forced_align(
    log_probs: torch.Tensor,       # [B, T, C]
    targets: torch.Tensor,         # [B, L]
    input_lengths: torch.Tensor,   # [B]
    target_lengths: torch.Tensor,  # [B]
    blank: int,
    return_states: bool = False,
):
    """Viterbi forced alignment over the CTC lattice: (labels [B, T], the
    emitted id per frame, blank where the blank wins; scores [B, T], the
    chosen state's log-prob) and with ``return_states`` the state per frame
    (2k + 1 emits token k, 2k is the blank after token k - 1).  Frames past
    the input length hold blank, 0 and 0.  Ties between the three
    predecessors go to the first (stay, then step, then skip), as
    ``jnp.argmax`` breaks them."""
    ext, emit, allow2 = _lattice(log_probs, targets, blank)
    b, t_max, _ = emit.shape
    alpha = _alpha0(emit)
    backptrs = []
    for t in range(1, t_max):
        a2 = torch.where(allow2, _shift(alpha, 2), NEG_INF)
        stacked = torch.stack([alpha, _shift(alpha, 1), a2])
        best_val, _ = stacked.max(dim=0)
        best = torch.argmax(stacked, dim=0)  # the first maximum
        active = (t < input_lengths)[:, None]
        alpha = torch.where(active, best_val + emit[:, t], alpha)
        backptrs.append(torch.where(active, best, 0))
    last, a_last, a_prev = _final(alpha, target_lengths)
    state = torch.where(a_last >= a_prev, last, torch.clamp(last - 1, min=0))
    states = [state] * t_max
    for t in range(t_max - 1, 0, -1):
        states[t] = state
        offset = backptrs[t - 1].gather(1, state[:, None])[:, 0]
        inside = t <= input_lengths - 1
        state = state - torch.where(inside, offset, 0)
    states[0] = state
    states = torch.stack(states, dim=1)  # [B, T]
    labels = ext.gather(1, states)
    scores = emit.gather(2, states[..., None])[..., 0]
    valid = (torch.arange(t_max, device=emit.device)[None, :]
             < input_lengths[:, None])
    labels = torch.where(valid, labels, blank)
    scores = torch.where(valid, scores, 0.0)
    if return_states:
        return labels, scores, torch.where(valid, states, 0)
    return labels, scores
