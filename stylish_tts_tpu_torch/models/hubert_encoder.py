"""HubertEncoder: frozen HuBERT features projected into the acoustic
``inter_dim`` through the RoPE transformer of the text encoder."""

from __future__ import annotations

import torch
from torch import nn

from ..config import ModelConfig
from .norms import Conv1x1, sequence_mask
from .text_encoder import TransformerEncoder


class HubertEncoder(nn.Module):
    """phones [B, T, hubert_dim] -> [B, T, inter_dim].  (The JAX module's
    ``input_cond_dim`` branch, which no model sets, is not ported.)"""

    def __init__(self, mc: ModelConfig):
        super().__init__()
        self.phone_emb = Conv1x1(mc.hubert.hidden_dim, mc.inter_dim)
        tc = mc.text_encoder
        self.encoder = TransformerEncoder(mc.inter_dim, tc.filter_channels,
                                          tc.heads, tc.layers,
                                          tc.kernel_size, tc.dropout)

    def forward(self, phones: torch.Tensor, phone_lengths: torch.Tensor
                ) -> torch.Tensor:
        x = self.phone_emb(phones)
        mask = sequence_mask(phone_lengths, x.shape[1]).to(x.dtype)[..., None]
        return self.encoder(x, mask)
