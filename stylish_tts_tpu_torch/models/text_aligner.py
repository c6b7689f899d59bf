"""CTC text aligner: a TDNN conv stack and a deep FFN -> log-softmax over
the tokens and the blank (the JAX package's ``models/text_aligner.py``).

Submodules and buffers carry the flax names: ``tdnn_{i}.Conv_0``,
``ffn_{i}``, ``out``, and the batch norms' running stats as the buffers
``bn_{i}.mean`` and ``bn_{i}.var`` (flax's ``batch_stats`` collection),
so ``convert.load_flax_params`` maps them by name alone.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .norms import Conv1d, Dropout, FlaxBatchNorm, sequence_mask


class TextAligner(nn.Module):
    def __init__(self, n_mels: int = 80, n_tokens: int = 178,
                 hidden_dim: int = 640, dropout: float = 0.1):
        super().__init__()
        self.n_tokens = n_tokens
        widths = [n_mels, hidden_dim, hidden_dim]
        for i, k in enumerate((5, 3, 3)):
            setattr(self, f"tdnn_{i}", Conv1d(widths[i], hidden_dim, k))
            setattr(self, f"bn_{i}", FlaxBatchNorm(hidden_dim))
        for i in range(5):
            setattr(self, f"ffn_{i}", nn.Linear(hidden_dim, hidden_dim))
        self.out = nn.Linear(hidden_dim, n_tokens + 1)
        self.dropout = Dropout(dropout)

    def forward(self, mel: torch.Tensor, lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """mel [B, T, n_mels], lengths [B] -> (log-probs [B, T, tokens + 1],
        lengths).  Dropout and the batch norms' batch statistics are on in
        train mode (``module.train()``)."""
        x = mel
        for i in range(3):
            mask = sequence_mask(lengths, x.shape[1]).to(x.dtype)[..., None]
            x = getattr(self, f"tdnn_{i}")(x * mask)
            x = getattr(self, f"bn_{i}")(F.relu(x))
            x = self.dropout(x)
        h = x
        for i in range(5):
            h = self.dropout(F.relu(getattr(self, f"ffn_{i}")(h)))
        logits = self.out(x + h)
        return torch.log_softmax(logits, dim=-1), lengths


def build_text_aligner(mc) -> TextAligner:
    """The aligner of ``mc``: 80 mel bins in, the text encoder's tokens
    plus the blank out; eval mode."""
    return TextAligner(n_mels=80, n_tokens=mc.text_encoder.tokens,
                       hidden_dim=mc.text_aligner.hidden_dim).eval()


BN_STATS = ("mean", "var")


def aligner_params(module: TextAligner) -> dict:
    """The aligner's parameters under flat flax names, without its batch
    norms' running stats: the layout of ``alignment_model.safetensors``
    (the JAX package exports ``params`` only)."""
    from ..convert import export_flax_params

    return {k: v for k, v in export_flax_params("text_aligner", module).items()
            if k.rsplit("/", 1)[-1] not in BN_STATS}


def load_aligner_params(path, module: TextAligner,
                        device: Optional[torch.device] = None) -> TextAligner:
    """Fill ``module``'s parameters from a params-only file; the batch
    norms' running stats stay as they are (at construction, mean 0 and
    variance 1, as the JAX package's ``align_text`` and ``AlignerScorer``
    leave them)."""
    from ..convert import export_flax_params, load_flax_params
    from ..utils.tensorfile import read_safetensors

    flat = read_safetensors(path)
    stats = {k: v for k, v in export_flax_params("text_aligner", module).items()
             if k.rsplit("/", 1)[-1] in BN_STATS}
    module.load_state_dict(load_flax_params("text_aligner",
                                            {**stats, **flat}, module))
    return module if device is None else module.to(device)
