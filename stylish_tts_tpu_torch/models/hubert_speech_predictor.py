"""The hubert-driven acoustic model and pitch/energy predictor of the
experimental ``hubert_acoustic`` stage: frozen HuBERT frame features take
the place of the aligned text encoding, the speaker vector the place of
the text style vector; no alignment is needed, the features are at mel
frame rate already.

``HubertSpeechPredictor`` repeats the features x4 to the freegan
generator's frame rate (the ringformer head takes the mel rate) and runs them through ``HubertEncoder``, the
decoder, the flow prior (and, with ``audio_gt``, the posterior) and the
generator, as ``SpeechPredictor`` does for text.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..config import ModelConfig
from .decoder import Decoder
from .flow import PosteriorEncoder, PriorEncoder, ResidualCouplingBlock
from .generator import DecoderPrediction
from .hubert_encoder import HubertEncoder
from .norms import AdaptiveDecoderBlock, Conv1x1, Dropout
from .prosody_encoder import ProsodyEncoder
from .speech_predictor import generator_head, head_draws, upsample_x4_linear
from .xut import mish


class HubertSpeechPredictor(nn.Module):
    def __init__(self, mc: ModelConfig):
        super().__init__()
        self.x4 = mc.generator.type == "freegan"
        s = mc.style_dim
        self.phone_encoder = HubertEncoder(mc)
        self.style1 = nn.Linear(mc.speaker_embedder.hidden_dim, s * 4)
        self.style2 = nn.Linear(s * 4, s * 2)
        self.style3 = nn.Linear(s * 2, s)
        self.dropout = Dropout(0.25)
        hidden = mc.decoder.hidden_dim
        self.decoder = Decoder(mc.inter_dim, hidden, mc.decoder.residual_dim,
                               s)
        flow_dim = hidden // 4
        self.prior_encoder = PriorEncoder(hidden, flow_dim)
        self.flow = ResidualCouplingBlock(
            flow_dim, flow_dim, kernel_size=5, n_layers=4, n_flows=8,
            cond_channels=s)
        self.posterior_encoder = PosteriorEncoder(
            flow_dim, flow_dim, n_fft=mc.n_fft, win_length=mc.win_length,
            hop_length=mc.hop_length // 4 if self.x4 else mc.hop_length,
            n_layers=12, cond_channels=s)
        self.post_flow = nn.Linear(flow_dim, hidden)
        self.generator = generator_head(mc)

    def forward(
        self,
        phones: torch.Tensor,         # [B, F_mel, hubert_dim]
        phone_lengths: torch.Tensor,  # [B]
        spk_emb: torch.Tensor,        # [B, speaker_embedder.hidden_dim]
        pitch: torch.Tensor,          # [B, F_mel]
        energy: torch.Tensor,         # [B, F_mel]
        audio_gt: Optional[torch.Tensor] = None,
        *,
        sample: bool = True,
        generator: Optional[torch.Generator] = None,
        pcph_noise: Optional[torch.Tensor] = None,
        pcph_phase: Optional[torch.Tensor] = None,
        nsf_draws: Optional[Dict[str, torch.Tensor]] = None,
    ) -> DecoderPrediction:
        if self.x4:
            phones4 = self.phone_encoder(
                torch.repeat_interleave(phones, 4, 1), phone_lengths * 4)
            pitch4 = upsample_x4_linear(pitch)
            energy4 = upsample_x4_linear(energy)
        else:
            phones4 = self.phone_encoder(phones, phone_lengths)
            pitch4, energy4 = pitch, energy
        s = self.dropout(mish(self.style1(spk_emb)))
        s = self.dropout(mish(self.style2(s)))
        style = self.style3(s)
        x = self.decoder(phones4, pitch4, energy4, style)
        text_stats = self.prior_encoder(x, sample=sample, generator=generator)
        text2mel_stats = self.flow(*text_stats, cond=style, reverse=True)
        if audio_gt is None:
            mel = self.post_flow(text2mel_stats[0])
        else:
            mel_stats = self.posterior_encoder(
                audio_gt, cond=style, sample=sample, generator=generator)
            mel2text_stats = self.flow(*mel_stats, cond=style, reverse=False)
            mel = self.post_flow(mel_stats[0])
        prediction = self.generator(
            mel, style, pitch4, generator=generator,
            **head_draws(self.x4, pcph_noise, pcph_phase, nsf_draws))
        if audio_gt is not None:
            prediction.text_stats = text_stats
            prediction.text2mel_stats = text2mel_stats
            prediction.mel_stats = mel_stats
            prediction.mel2text_stats = mel2text_stats
        return prediction


class HubertPitchEnergyPredictor(nn.Module):
    """phones [B, F_mel, hubert_dim] and the speaker vector -> (F0,
    energy), each [B, F_mel]: a prosody encoder, then 3 AdaIN blocks and
    a 1x1 head each."""

    def __init__(self, mc: ModelConfig):
        super().__init__()
        s = mc.style_dim
        channels = mc.inter_dim + s
        dropout = mc.pitch_energy_predictor.dropout
        self.phone_quant = Conv1x1(mc.hubert.hidden_dim, mc.inter_dim)
        self.style_encoder = nn.Linear(mc.speaker_embedder.hidden_dim, s)
        self.prosody_encoder = ProsodyEncoder(s, mc.inter_dim, 3, dropout=0.2)
        for head in ("f0", "energy"):
            for i in range(3):
                setattr(self, f"{head}_block_{i}", AdaptiveDecoderBlock(
                    channels, channels, s, dropout))
            setattr(self, f"{head}_proj", Conv1x1(channels, 1))

    def forward(self, phones: torch.Tensor, phone_lengths: torch.Tensor,
                spk_emb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        style = self.style_encoder(spk_emb)
        x = self.prosody_encoder(self.phone_quant(phones), style,
                                 phone_lengths)
        outputs = []
        for head in ("f0", "energy"):
            h = x
            for i in range(3):
                h = getattr(self, f"{head}_block_{i}")(h, style)
            outputs.append(getattr(self, f"{head}_proj")(h)[..., 0])
        return outputs[0], outputs[1]
