"""Synthesis: phonemes -> 24 kHz audio through the five inference models.

The same graphs as the JAX package's Synthesizer: a duration graph, a style
graph (pe_text_encoder -> pe_text_style_encoder) and a speech graph
(durations -> alignment -> pe_text_encoder -> pitch_energy_predictor ->
speech_predictor -> int16 PCM), over the same buckets: text padded to
64-token buckets, frames rounded up to the 20-frame grid.  Under a
profiler a request's parts are spans (``utils/profiling.py``):
``synth.batch`` holds ``synth.encode``, ``synth.durations``,
``synth.style``, ``synth.speech`` and the three ``synth.upload`` of a
batch; ``synth.readback`` is the PCM's copy to the host.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig
from ..device import resolve_device
from ..duration import DurationProcessor
from ..text import TextCleaner
from ..utils.profiling import span


def frame_bucket(frames: int) -> int:
    """Round frames up to the 20-frame grid used by training buckets."""
    return max(60, -(-frames // 20) * 20)


def text_bucket(n_tokens: int) -> int:
    """Round a token count up to a 64-token bucket (at most 512)."""
    return min(max(64, -(-n_tokens // 64) * 64), 512)


def pcm16(audio: torch.Tensor) -> torch.Tensor:
    """tanh-bounded float audio -> int16 PCM (truncating, as the JAX
    package's ``astype(int16)``), without a check."""
    return torch.clamp(audio * 32767.0, -32768.0, 32767.0).to(torch.int16)


def to_pcm16(audio: torch.Tensor) -> torch.Tensor:
    """``pcm16`` that raises on NaN or inf, which the integer cast would
    otherwise turn into silence."""
    if not bool(torch.isfinite(audio).all()):
        raise FloatingPointError("synthesis produced non-finite audio")
    return pcm16(audio)


class BatchAudio(NamedTuple):
    """One dispatched batch: int16 PCM [B, frames * hop] on the device,
    each utterance's frame total, and whether the float audio was finite
    (a bool tensor on the device, read when the PCM is)."""
    pcm: torch.Tensor
    totals: List[int]
    finite: torch.Tensor


def check_servable(model_config: ModelConfig) -> None:
    """Raise for a configuration the reference cannot serve: a ringformer
    voice.  Its conformers' batch norms need their running stats, and the
    reference's artifact holds params only (its Synthesizer applies
    ``{"params": ...}`` and fails on the missing ``batch_stats``), so the
    port refuses it here rather than serve what the reference cannot."""
    if model_config.generator.type == "ringformer":
        raise NotImplementedError(
            "a ringformer voice cannot be served: the reference's inference "
            "artifact holds params only, no batch stats for the generator's "
            "conformer batch norms")


class Synthesizer:
    """TTS inference over static buckets on one device."""

    def __init__(
        self,
        model_config: ModelConfig,
        models: Dict[str, nn.Module],
        *,
        sample_seed: int = 0,
        device: Optional[Union[str, torch.device]] = None,
    ):
        check_servable(model_config)
        self.device = resolve_device(device)
        self.mc = model_config
        self.models = {k: m.to(self.device).eval() for k, m in models.items()}
        self.text_cleaner = TextCleaner(model_config.symbol)
        self.duration_processor = DurationProcessor(
            model_config.duration_predictor.duration_classes,
            model_config.duration_predictor.max_duration,
        )
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(sample_seed)

    # -- graphs ----------------------------------------------------------- #

    @torch.no_grad()
    def duration_logits(self, tokens: torch.Tensor, lengths: torch.Tensor
                        ) -> torch.Tensor:
        return self.models["duration_predictor"](tokens, lengths)

    @torch.no_grad()
    def style_graph(self, tokens: torch.Tensor, lengths: torch.Tensor
                    ) -> torch.Tensor:
        """Text-derived style vector [B, style_dim]."""
        with span("synth.style"):
            pe_enc, _, _ = self.models["pe_text_encoder"](tokens, lengths)
            return self.models["pe_text_style_encoder"](pe_enc, lengths)

    @torch.no_grad()
    def speech_audio(
        self,
        tokens: torch.Tensor,     # [B, T] int
        lengths: torch.Tensor,    # [B] int
        durations: torch.Tensor,  # [B, T] int frames per token
        frames: int,
        style: torch.Tensor,      # [B, style_dim]
    ) -> torch.Tensor:
        """Float audio [B, frames * hop_length]; the latent and the prior's
        noise are drawn from ``self.generator``."""
        with span("synth.speech"):
            alignment = (self.duration_processor
                         .batched_duration_to_alignment(durations, frames))
            pe_enc, _, _ = self.models["pe_text_encoder"](tokens, lengths)
            pitch, energy = self.models["pitch_energy_predictor"](
                pe_enc, lengths, alignment, style)
            pred = self.models["speech_predictor"](
                tokens, lengths, alignment, pitch, energy,
                generator=self.generator)
            return pred.audio

    # -- requests --------------------------------------------------------- #

    def encode_batch(self, phoneme_list: List[str]
                     ) -> Tuple[torch.Tensor, torch.Tensor, List[int]]:
        """Bracket each text with pads and pad all to one text bucket."""
        with span("synth.encode"):
            encoded = [[0] + self.text_cleaner(p) + [0]
                       for p in phoneme_list]
            bucket = text_bucket(max(len(ids) for ids in encoded))
            tokens, lengths = np.zeros((len(encoded), bucket), np.int64), []
            for i, ids in enumerate(encoded):
                tokens[i, : len(ids)] = ids
                lengths.append(len(ids))
            return (self.upload(tokens), self.upload(np.array(lengths)),
                    lengths)

    def upload(self, array: np.ndarray) -> torch.Tensor:
        """A host array on the device without waiting for the device: on
        the card a pinned copy, copied asynchronously (a copy from pageable
        memory would wait for the work already queued)."""
        with span("synth.upload"):
            t = torch.from_numpy(array)
            if self.device.type != "cuda":
                return t.to(self.device)
            return t.pin_memory().to(self.device, non_blocking=True)

    def predict_durations(self, phonemes: str) -> np.ndarray:
        tokens, lengths, (n,) = self.encode_batch([phonemes])
        logits = self.duration_logits(tokens, lengths)
        durs = self.duration_processor.prediction_to_duration(logits[0])
        return durs[:n].cpu().numpy().astype(np.int64)

    def text_style(self, phonemes: str) -> torch.Tensor:
        """Style vector [1, style_dim] for one utterance."""
        tokens, lengths, _ = self.encode_batch([phonemes])
        return self.style_graph(tokens, lengths)

    def synthesize(
        self,
        phonemes: str,
        speed: float = 1.0,
        fixed_duration: Optional[int] = None,
        style: Optional[torch.Tensor] = None,
    ) -> np.ndarray:
        """One utterance -> float32 waveform at 24 kHz.

        ``fixed_duration`` replaces the duration model's output with a
        constant frames-per-token (the graph still runs), for benchmarks
        with untrained weights; ``style`` overrides the text-derived one."""
        with span("synth.batch"):
            tokens, lengths, (n,) = self.encode_batch([phonemes])
            with span("synth.durations"):
                logits = self.duration_logits(tokens, lengths)
                if fixed_duration is not None:
                    durs = np.full(n, fixed_duration, np.int64)
                else:
                    durs = self.duration_processor.prediction_to_duration(
                        logits[0]).cpu().numpy()[:n]
                if speed != 1.0:
                    durs = np.maximum(1, np.round(durs / speed)).astype(
                        np.int64)
                total_frames = int(durs.sum())
                dur_vec = np.zeros((1, tokens.shape[1]), np.int64)
                dur_vec[0, :n] = durs
            if style is None:
                style = self.style_graph(tokens, lengths)
            audio = self.speech_audio(
                tokens, lengths, self.upload(dur_vec),
                frame_bucket(total_frames), style)
        with span("synth.readback"):
            samples = total_frames * self.mc.hop_length
            pcm = to_pcm16(audio[0, :samples]).cpu().numpy()
        return pcm.astype(np.float32) / 32767.0

    def synthesize_batch_async(
        self,
        phoneme_list: List[str],
        speed: float = 1.0,
        fixed_duration: Optional[int] = None,
    ) -> BatchAudio:
        """Dispatch one batch, all utterances padded to one (text-bucket,
        frame-bucket) pair and decoded in one pass, without waiting for
        the audio: its PCM stays on the device, so the caller can queue
        the next batch while this one computes (the pipelined serving
        loop).  The durations are read back first unless
        ``fixed_duration`` is given: they set the frame bucket."""
        with span("synth.batch"):
            tokens, lengths, counts = self.encode_batch(phoneme_list)
            with span("synth.durations"):
                logits = self.duration_logits(tokens, lengths)
                if fixed_duration is not None:
                    durs = np.full(tuple(tokens.shape), fixed_duration,
                                   np.int64)
                else:
                    durs = self.duration_processor.prediction_to_duration(
                        logits).cpu().numpy()
                dur_vec = np.zeros(tuple(tokens.shape), np.int64)
                totals = []
                frames = 60
                for i, n in enumerate(counts):
                    d = np.maximum(1, np.round(durs[i, :n] / speed)).astype(
                        np.int64)
                    dur_vec[i, :n] = d
                    totals.append(int(d.sum()))
                    frames = max(frames, frame_bucket(int(d.sum())))
            style = self.style_graph(tokens, lengths)
            audio = self.speech_audio(
                tokens, lengths, self.upload(dur_vec),
                frames, style)
            return BatchAudio(pcm16(audio), totals,
                              torch.isfinite(audio).all())

    def synthesize_batch(
        self,
        phoneme_list: List[str],
        speed: float = 1.0,
        fixed_duration: Optional[int] = None,
    ) -> List[np.ndarray]:
        """``synthesize_batch_async``, then its PCM copied to the host and
        cut to each utterance's frames; raises on non-finite audio."""
        pcm, totals, finite = self.synthesize_batch_async(
            phoneme_list, speed=speed, fixed_duration=fixed_duration)
        with span("synth.readback"):
            pcm = pcm.cpu().numpy()
            finite = bool(finite)
        if not finite:
            raise FloatingPointError("synthesis produced non-finite audio")
        return [
            pcm[i, : totals[i] * self.mc.hop_length].astype(np.float32)
            / 32767.0
            for i in range(len(phoneme_list))
        ]

    def synthesize_longform(
        self,
        sentences: List[str],
        silence_ms: float = 120.0,
        crossfade_ms: float = 15.0,
        trim_threshold: float = 1000.0 / 32768.0,
        style_alpha: float = 0.7,
        style_memory: int = 3,
    ) -> np.ndarray:
        """Sentence-streaming synthesis: silence trimming per sentence,
        linear cross-fades plus a gap between sentences, and each
        sentence's style blended with the last ``style_memory`` ones."""
        sr = self.mc.sample_rate
        gap = np.zeros(int(sr * silence_ms / 1000.0), np.float32)
        fade = max(1, int(sr * crossfade_ms / 1000.0))
        recent_styles: List[torch.Tensor] = []
        out: Optional[np.ndarray] = None
        for sentence in sentences:
            style = self.text_style(sentence)
            if recent_styles:
                others = sum(recent_styles) / len(recent_styles)
                style = style_alpha * style + (1.0 - style_alpha) * others
            recent_styles = (recent_styles + [style])[-style_memory:]
            audio = trim_silence(self.synthesize(sentence, style=style),
                                 trim_threshold)
            if out is None:
                out = audio
                continue
            out = np.concatenate([out, gap])
            n = min(fade, out.shape[0], audio.shape[0])
            if n > 1:
                w = np.linspace(0.0, 1.0, n, dtype=np.float32)
                head = w * audio[:n] + (1.0 - w) * out[-n:]
                out = np.concatenate([out[:-n], head, audio[n:]])
            else:
                out = np.concatenate([out, audio])
        return out if out is not None else np.zeros(0, np.float32)


def trim_silence(
    audio: np.ndarray, threshold: float = 1000.0 / 32768.0,
    keep_tail: int = 2400,
) -> np.ndarray:
    """Trim leading/trailing samples below an amplitude threshold, keeping
    a short release tail."""
    loud = np.flatnonzero(np.abs(audio) >= threshold)
    if loud.size == 0:
        return audio
    start = int(loud[0])
    end = min(audio.shape[0], int(loud[-1]) + 1 + keep_tail)
    return audio[start:end]


@dataclass
class RTFReport:
    audio_seconds: float
    wall_seconds: float

    @property
    def rtf(self) -> float:
        return self.audio_seconds / self.wall_seconds


def measure_rtf(
    synthesizer: Synthesizer, phonemes: str, iters: int = 5
) -> RTFReport:
    """Real-time factor of ``synthesize`` after one warm-up call.  Each call
    returns audio on the host, so the timed region ends with the device's
    work done."""
    synthesizer.synthesize(phonemes)
    t0 = time.perf_counter()
    total = 0.0
    for _ in range(iters):
        audio = synthesizer.synthesize(phonemes)
        total += audio.shape[0] / synthesizer.mc.sample_rate
    return RTFReport(total, time.perf_counter() - t0)
