"""A training curve of the acoustic stage at full width on the card.

    python -m stylish_tts_tpu_torch.scripts.train_curve [--steps 200]
        [--out FILE]

Writes the synthetic dataset of ``chip_smoke.py``'s runtime phase (160
segments of 0.7-1.3 x 5.75 s, 158 train) to a temporary directory and runs
CLI ``train`` in-process on it from the acoustic stage, at the default
full-width ModelConfig and the default run config (bf16), with the
heuristic batch plan of ``probe_batch_max`` 8 (the bin of 460 frames takes
batches of 8), no validation and the one final save, for ``--steps``
steps.  Every 10 steps the loop logs the means of the window's metrics and
the discriminator-loss EMA after its last step; this prints, per window,
``mel``, ``generator``, ``discriminator``, the EMA, the LR multiplier that
EMA gives the next discriminator update, and the window's wall ms per
step (first visits of a batch shape included), then one JSON object
of all of it.  Runs on the card only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

SEGMENTS, SECONDS, WINDOW = 160, 5.75, 10


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--out", default=None, help="JSON file to write")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("train_curve: CUDA is not available", file=sys.stderr)
        return 1
    from stylish_tts_tpu_torch import cli
    from stylish_tts_tpu_torch.config import Config, dump_json
    from stylish_tts_tpu_torch.losses import disc_lr_multiplier
    from stylish_tts_tpu_torch.utils.synthetic import make_synthetic_dataset

    card = card_line()
    print(card)
    with tempfile.TemporaryDirectory(prefix="train_curve_") as tmp:
        root = Path(tmp)
        make_synthetic_dataset(root / "data", n_segments=SEGMENTS,
                               seconds=SECONDS)
        cfg = Config()
        cfg.dataset.path = str(root / "data")
        cfg.training.aot_memory_plan = False
        cfg.training_plan.acoustic.probe_batch_max = 8
        cfg.training.log_interval = WINDOW
        cfg.training.val_interval = cfg.training.save_interval = 10**9
        (root / "config.json").write_text(dump_json(cfg))
        t0 = time.perf_counter()
        cli.main(["train", "--config", str(root / "config.json"), "--out",
                  str(root / "out"), "--max-steps", str(args.steps)])
        wall = time.perf_counter() - t0
        stats = json.loads((root / "out" / "acoustic" / "train_stats.json")
                           .read_text())
    rows = []
    for entry in stats["logs"]:
        ema = entry["disc_ema"]["mrd"]
        rows.append({
            "step": entry["step"], "mel": entry["metrics"]["mel"],
            "generator": entry["metrics"]["generator"],
            "discriminator": entry["metrics"]["discriminator"],
            "disc_ema": ema,
            "disc_lr_multiplier": float(disc_lr_multiplier(
                torch.tensor(ema))),
            "ms_per_step": entry["seconds"] * 1e3 / entry["steps"],
            "first_visits": entry["first_visits"], "loss": entry["loss"]})
    print(f"acoustic training curve, {args.steps} steps, means over each "
          f"{WINDOW}-step window [{card}]")
    print("step  mel     generator  discriminator  disc_ema  multiplier  "
          "ms/step  first visits")
    for r in rows:
        print(f"{r['step']:4d}  {r['mel']:.4f}  {r['generator']:.4f}     "
              f"{r['discriminator']:.4f}         {r['disc_ema']:.4f}    "
              f"{r['disc_lr_multiplier']:.4f}      {r['ms_per_step']:.1f}  "
              f"{r['first_visits']}")
    result = {"card": card, "steps": args.steps, "window": WINDOW,
              "wall_s": wall, "rows": rows,
              "batches": stats["batches"]}
    print(f"train_curve: {wall:.1f} s in all, {stats['steps']} steps, "
          f"first visits {stats['first_visits']}, guard snapshots "
          f"{stats['guard']['snapshots']} in "
          f"{stats['guard']['snapshot_s']:.2f} s [{card}]")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
