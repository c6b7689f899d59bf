"""Readings that set a cell's limits, on the card, at the cell's own size:

    python3 -m portbench.control --workload NAME --seeds 1,2,3 [--seconds S]

For each seed, one line of JSON with the numbers ``compare`` computes:

- ``program``: the program against the reference (the lower reading);
- ``control``: the reference put in the program's place in the nearest
  precision below the configuration's (training, which states bf16: every
  model's parameters, inputs and leaf modules' outputs rounded to float8
  e4m3 at a per-tensor scale and their gradients to e5m2, ``compare.fp8``; synthesis, which states f32 with TF32 off: the
  reference with TF32 on);
- ``bf16`` (training only): a witness, the reference on bf16 copies of
  each model's parameters and inputs where the program casts;
- synthesis only, ``cufft_stft``: a witness, the reference with
  ``torch.stft`` (cuFFT) for its STFT, against the reference;
- training only, ``half_batch``: the reference on the first half of each
  batch's rows, its mean over those, against the whole batch (a fault a
  cell can have).  A step that returns its state unchanged reads 1 on
  ``grad_gap`` and ``change_gap`` by their definition and needs no run;
- training only, ``wgrad_x2``: the reference with the weight gradient of
  each of the MRD's spec-conv layers doubled (a fault of the wgrad
  kernel's sum), against the reference.

The program's and the control's seeds run in one process.  Synthesis
cells run a short window (``--seconds``) at the cell's own load.  Not run by
the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from contextlib import ExitStack
from unittest import mock

import torch

from . import card, compare, registry, synth_cell, train_cell
from .counts import flops


def _numbers(values: dict) -> dict:
    return {k: v for k, (v, _) in values.items()}


def train_readings(cell, seed: int, device, control: bool = True) -> dict:
    s = train_cell.setup(cell, seed, device, warm=False)
    prog, pool = s["prog"], s["pool"]
    del s
    gc.collect()
    torch.cuda.empty_cache()
    ref = train_cell.reference_readings(cell, seed, device, pool)
    runs = {"program": prog}
    if control:
        half = [{k: v[: len(v) // 2] for k, v in b.items()} for b in pool]
        runs.update(
            # a witness: the reference on bf16 copies of each model's
            # parameters and inputs, where the program casts
            bf16=train_cell.reference_readings(cell, seed, device, pool,
                                               cast=flops.bf16,
                                               leaves=False),
            control=train_cell.reference_readings(cell, seed, device, pool,
                                                  cast=compare.fp8),
            half_batch=train_cell.reference_readings(cell, seed, device,
                                                     half))
        with doubled_wgrad():
            runs["wgrad_x2"] = train_cell.reference_readings(cell, seed,
                                                             device, pool)
    out = {}
    for name, got in runs.items():
        out[name] = dict(_numbers(compare.train_numbers(got, ref)),
                         **compare.train_details(got, ref))
    mrd = [k for k in ref["grad"] if k.startswith("mrd.")]
    out["mrd_leaf_gaps"] = {
        name: compare.leaf_gaps(got["grad"], {k: ref["grad"][k]
                                              for k in mrd})
        for name, got in runs.items() if name != "half_batch"}
    out["loss"] = {k: v["loss"] for k, v in runs.items()}
    out["loss"]["reference"] = ref["loss"]
    r = ref["metrics"][0]
    out["first_step_term_gaps"] = {
        k: {m: abs(v["metrics"][0][m] - r[m]) / abs(r[m]) for m in r}
        for k, v in runs.items()}
    return out


def doubled_wgrad():
    """A patch of the reference's MRD under which every spec-conv layer's
    weight gradient comes out doubled."""
    from .reference.models import discriminator

    real = discriminator.spec_conv2d

    def doubled(x, w, b, stride=1, leaky=0.1):
        if w.requires_grad:
            w = w * 1.0
            w.register_hook(lambda g: 2.0 * g)
        return real(x, w, b, stride, leaky)

    return mock.patch.object(discriminator, "spec_conv2d", doubled)


def synth_readings(cell, seed: int, device, seconds: float,
                   control: bool = True) -> dict:
    out = synth_cell.run(cell, seed, seconds, False, device,
                         time.perf_counter())
    if not control:
        return {"program": _numbers(out["numbers"])}
    checked, ref_mc = out["checked"], out["ref_mc"]
    fixed = cell.config["synthesis"]["fixed_duration"]
    hop = ref_mc.hop_length
    refs = synth_cell.reference_pcm(ref_mc, seed, device, checked, fixed)
    ctl = synth_cell.reference_pcm(ref_mc, seed, device, checked, fixed,
                                   allow_tf32=True)
    with ExitStack() as stack:
        for patch in _cufft_stft():
            stack.enter_context(patch)
        witness = synth_cell.reference_pcm(ref_mc, seed, device, checked,
                                           fixed)

    def worst(pcms):
        as_program = [dict(r, pcm=[p[i, :(len(ids) + 2) * fixed * hop]
                                   for i, ids in enumerate(r["ids"])],
                           finite=True) for r, p in zip(checked, pcms)]
        return max(synth_cell.gaps(as_program, refs, fixed, hop))[0]

    return {"program": _numbers(out["numbers"]),
            "control": {"pcm_gap": worst(ctl)},
            "cufft_stft": {"pcm_gap": worst(witness)},
            "utterances": out["readings"]["checked_utterances"],
            "synth_audio_s_per_s": out["e2e"]["synth_audio_s_per_s"]}


def _cufft_stft():
    """Patches that put ``torch.stft`` (cuFFT) in place of the reference's
    STFT (a DFT by matrix product): a witness that two sound STFTs alone
    part the synthesis's PCM (the generator reads the prior STFT's raw
    ``atan2``)."""
    from .reference.models import flow
    from .reference.ops import mel, multi_spectrogram, stft, stft_kernel

    def stft_forward(x, *, n_fft: int, hop_length: int, win_length: int):
        window = stft._padded_window(win_length, n_fft).to(x.device)
        z = torch.stft(x, n_fft, hop_length, n_fft, window, center=True,
                       pad_mode="reflect", return_complex=True)
        return z.real.transpose(1, 2), z.imag.transpose(1, 2)

    return [mock.patch.object(m, "stft_forward", stft_forward)
            for m in (flow, mel, multi_spectrogram, stft_kernel)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--control-seeds", type=int, default=None,
                   help="run the control on the first N seeds only (all)")
    args = p.parse_args(argv)
    cell = registry.cell(args.workload)
    device = card.require(cell.chips)
    seeds = [int(s) for s in args.seeds.split(",")]
    n_control = len(seeds) if args.control_seeds is None \
        else args.control_seeds
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        if cell.traffic["kind"] == "train":
            line = train_readings(cell, seed, device, i < n_control)
        elif cell.traffic["kind"] == "synth":
            line = synth_readings(cell, seed, device, args.seconds,
                                  i < n_control)
        else:
            raise ValueError(f"no control for mixes of kind "
                             f"{cell.traffic['kind']!r}")
        line.update(workload=cell.name, seed=seed,
                    seconds=time.perf_counter() - t0)
        print(json.dumps(line), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
