"""A ``synth`` cell: batch synthesis through ``export/infer.py:
Synthesizer``, one client in a closed loop.

``entry`` ``synthesize_batch_async`` keeps ``in_flight`` batches dispatched
and reads the oldest one's PCM back to the host before it dispatches the
next (the pipelined serving loop); ``synthesize_batch`` calls the next batch
when the last returns; ``synthesize`` (``batch`` 1) calls the next
utterance when the last returns.  Another entry is refused.  Durations are fixed at ``fixed_duration`` frames a
phoneme (the duration head is random; its graph still runs).

Set-up draws the five inference models' weights on the card (rule
``speech``), warms up the mix's largest text and frame bucket and a few
batches of the cycle.  Every utterance returned in the window is kept on
the host, with its batch and the sampling generator's state before the
batch.  Once the window has closed and the program is freed, the
reference recomputes a sample of the batches, drawn from the seed with the
batch of the longest utterance in it, from the same weights, text and
noise (the generator's state), and ``compare.pcm_gap`` decides
``correct``.
"""

from __future__ import annotations

import gc
import json
import time
from collections import deque
from typing import Dict, List

import numpy as np
import torch

from . import compare, traffic, weights
from .counts import flops as flop_counts
from .reference.text import TextCleaner
from .trace import CallRecorder, profiled, segment
from .train_cell import PhaseClock, stream_seed

WEIGHT_STREAM, SAMPLE_STREAM, CHECK_STREAM = 21, 22, 23


def drawn_weights(ref_mc, seed: int, device) -> Dict[str, Dict]:
    from .reference import build

    gen = torch.Generator(device=device).manual_seed(
        stream_seed(seed, WEIGHT_STREAM))
    with torch.device("meta"):
        shapes = build.inference_models(ref_mc)
    drawn = {k: weights.draw(m, "speech", gen, device)
             for k, m in shapes.items()}
    weights.speech_levels(drawn, shapes["speech_predictor"].flow.n_flows)
    return drawn


ENTRIES = ("synthesize_batch_async", "synthesize_batch", "synthesize")


class Client:
    """The closed loop over one Synthesizer: ``send`` dispatches a batch,
    ``receive`` returns the oldest one's utterances as int16 arrays."""

    def __init__(self, synth, mix: dict, fixed: int):
        if mix["entry"] not in ENTRIES:
            raise ValueError(f"no synthesis entry {mix['entry']!r}: one of "
                             f"{ENTRIES}")
        if mix["entry"] == "synthesize" and mix["batch"] != 1:
            raise ValueError("entry 'synthesize' takes one utterance a "
                             "call: batch 1")
        if mix["entry"] != "synthesize_batch_async" and mix["in_flight"] != 1:
            raise ValueError(f"entry {mix['entry']!r} returns before the "
                             f"next call: in_flight 1")
        self.synth, self.mix, self.fixed = synth, mix, fixed
        self.pending = deque()
        self.dispatch_s: List[float] = []

    def send(self, texts: List[str], index: int) -> None:
        state = self.synth.generator.get_state()
        t0 = time.perf_counter()
        if self.mix["entry"] == "synthesize_batch_async":
            out = self.synth.synthesize_batch_async(
                texts, fixed_duration=self.fixed)
            self.dispatch_s.append(time.perf_counter() - t0)
        else:
            out = None
        self.pending.append((index, texts, state, t0, out))

    def _call(self, texts: List[str]) -> List[np.ndarray]:
        """The whole request of a blocking entry, as float audio."""
        if self.mix["entry"] == "synthesize":
            return [self.synth.synthesize(texts[0],
                                          fixed_duration=self.fixed)]
        return self.synth.synthesize_batch(texts, fixed_duration=self.fixed)

    def receive(self) -> dict:
        index, texts, state, t0, out = self.pending.popleft()
        hop = self.synth.mc.hop_length
        if out is None:  # a blocking entry: the call is the whole request
            try:
                audio = self._call(texts)
                pcm = [np.rint(a * 32767.0).astype(np.int16) for a in audio]
                finite = True
            except FloatingPointError:
                pcm, finite = [], False
        else:
            host = out.pcm.cpu().numpy()
            finite = bool(out.finite)
            pcm = [host[i, :t * hop] for i, t in enumerate(out.totals)]
        done = time.perf_counter()
        return {"index": index, "texts": texts, "state": state,
                "latency_s": done - t0, "pcm": pcm, "finite": finite}


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    from stylish_tts_tpu_torch.config import load_model_config_json
    from stylish_tts_tpu_torch.export.infer import Synthesizer
    from stylish_tts_tpu_torch.models import build_models
    from stylish_tts_tpu_torch.ops.build import build

    from .reference.config import load_model_config_json as ref_config

    mix, conf = cell.traffic, cell.config
    model_json = json.dumps(conf["model"])
    mc, ref_mc = load_model_config_json(model_json), ref_config(model_json)
    fixed = conf["synthesis"]["fixed_duration"]
    clock = PhaseClock()
    torch.empty(1, device=device)
    clock("cuda")
    build(["stft"])
    clock("build")

    drawn = drawn_weights(ref_mc, seed, device)
    with torch.device(device):
        models = build_models(mc)
    for key, model in models.items():
        if key in drawn:
            model.load_state_dict(drawn[key])
    del drawn
    synth = Synthesizer(mc, models, device=device,
                        sample_seed=stream_seed(seed, SAMPLE_STREAM))
    clock("weights and models")
    cycle = traffic.synth_cycle(mc, mix, seed)
    client = Client(synth, mix, fixed)
    k = mix["in_flight"]

    def drive(batches, record):
        for i, texts in batches:
            if len(client.pending) == k:
                record(client.receive())
            client.send(texts, i)
        while client.pending:
            record(client.receive())

    warm = [(-1, traffic.longest_batch(mc, mix, seed))] + [
        (i, cycle[i]) for i in range(mix["warm_batches"])]
    clock("texts")
    drive(warm, lambda r: None)
    torch.cuda.synchronize()
    clock("warm-up")
    clock.report()
    torch.cuda.reset_peak_memory_stats()
    client.dispatch_s.clear()
    setup_s = time.perf_counter() - t_start

    returned: List[dict] = []
    t0 = time.perf_counter()

    def batches():
        n = 0
        while time.perf_counter() - t0 < seconds:
            yield n, cycle[n % len(cycle)]
            n += 1

    drive(batches(), returned.append)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()

    seg = None
    if trace:
        seg = _traced(client, cycle, len(returned), mix, mc, drive)

    host = {"dispatch_s": list(client.dispatch_s)}
    del synth, models, client
    gc.collect()
    torch.cuda.empty_cache()

    utterances = [(r, i) for r in returned for i in range(len(r["texts"]))]
    ok = [r for r in returned if r["finite"]]
    audio_s = sum(len(p) for r in ok for p in r["pcm"]) / mc.sample_rate
    latencies = [r["latency_s"] for r, _ in utterances]
    checked = sample(returned, mix["check_batches"], seed)
    cleaner = TextCleaner(ref_mc.symbol)
    for r in checked:
        r["ids"] = [cleaner(t) for t in r["texts"]]
    refs = reference_pcm(ref_mc, seed, device, checked, fixed)
    found = gaps(checked, refs, fixed, ref_mc.hop_length)
    worst = max(found, key=lambda g: g[0])
    e2e = {"synth_audio_s_per_s": audio_s / window_s, "setup_s": setup_s}
    if latencies:
        e2e["synth_p95_ms"] = 1e3 * float(np.percentile(latencies, 95))
    return {
        "setup_s": setup_s, "window_s": window_s, "peak_bytes": peak,
        "attempted": len(utterances),
        "failed": len(utterances) - sum(len(r["pcm"]) for r in ok),
        "e2e": e2e, "numbers": {"pcm_gap": worst[:2]}, "segment": seg,
        "host": host, "checked": checked, "ref_mc": ref_mc,
        "readings": {"utterances": len(utterances),
                     "checked_utterances": len(found),
                     "latency_samples": len(latencies),
                     "latency_p50_ms": 1e3 * float(np.median(latencies))},
    }


def _traced(client, cycle, start: int, mix: dict, mc, drive):
    """A profiled segment of ``trace_batches`` batches after the window,
    with the STFT kernel's launches recorded, and each batch's model FLOP."""
    from stylish_tts_tpu_torch.ops import stft_kernel

    rec = CallRecorder()
    rec.wrap(stft_kernel.stft_forward, "launch", "stft",
             lambda x, n_fft, hop, win: (*x.shape, n_fft, hop))
    units = mix["trace_batches"]
    seen = []
    try:
        with profiled() as held:
            drive([(start + i, cycle[(start + i) % len(cycle)])
                   for i in range(units)], seen.append)
    finally:
        rec.restore()
    seg = segment(held.events, units, rec.calls)
    fixed = client.fixed
    cleaner = TextCleaner(mc.symbol)
    from .reference.build import frame_bucket, text_bucket

    for r in seen:
        lengths = [len(cleaner(t)) + 2 for t in r["texts"]]
        frames = max(60, max(frame_bucket(fixed * n) for n in lengths))
        seg.flops.append(flop_counts.synth_batch_flops(
            mc, text_bucket(max(lengths)), frames, len(lengths)))
    return seg


def sample(returned: List[dict], count: int, seed: int) -> List[dict]:
    """``count`` returned batches drawn from the seed, the one holding the
    longest utterance among them."""
    if not returned:
        return []
    longest = max(range(len(returned)), key=lambda i: max(
        (len(p) for p in returned[i]["pcm"]), default=0))
    rest = [i for i in range(len(returned)) if i != longest]
    picked = traffic.rng(seed, CHECK_STREAM).permutation(rest)[:count - 1]
    return [returned[i] for i in [longest, *sorted(picked)]]


def reference_pcm(ref_mc, seed: int, device, checked: List[dict],
                  fixed: int, allow_tf32: bool = False) -> List[np.ndarray]:
    """The reference's int16 PCM [B, samples] of each ``checked`` batch,
    recomputed from the same weights, text and generator state, in f32
    (TF32 only with ``allow_tf32``: the control)."""
    from .reference import build

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    torch.backends.cudnn.allow_tf32 = allow_tf32
    try:
        drawn = drawn_weights(ref_mc, seed, device)
        with torch.device("meta"):
            shells = build.inference_models(ref_mc)
        models = build.loaded(shells, drawn, device)
        cleaner = TextCleaner(ref_mc.symbol)
        out = []
        for r in checked:
            gen = torch.Generator(device=device)
            gen.set_state(r["state"])
            ids = [cleaner(t) for t in r["texts"]]
            out.append(build.speech_pcm(ref_mc, models, ids, fixed, gen,
                                        device))
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
        gc.collect()
        torch.cuda.empty_cache()


def gaps(checked: List[dict], refs: List[np.ndarray], fixed: int,
         hop: int) -> List[tuple]:
    """(pcm_gap, where) of every utterance of the ``checked`` batches
    against the reference's PCM; one the program did not return reads
    infinity."""
    out = []
    for r, ref in zip(checked, refs):
        for i, text_ids in enumerate(r["ids"]):
            want = ref[i, :(len(text_ids) + 2) * fixed * hop]
            where = f"batch {r['index']} utterance {i}"
            if not r["finite"] or i >= len(r["pcm"]):
                out.append((float("inf"), where))
            else:
                out.append((compare.pcm_gap(r["pcm"][i], want), where))
    return out
