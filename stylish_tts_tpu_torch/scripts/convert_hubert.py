"""Convert a local HuBERT checkpoint directory to the flat flax names that
``hubert.weights_path`` reads (the hubert/CFM stages' frozen encoder).

    python -m stylish_tts_tpu_torch.scripts.convert_hubert --model DIR --out hubert.safetensors [--layers N]

DIR holds ``config.json`` and ``model.safetensors`` or
``pytorch_model.bin`` (e.g. ``dr87/spinv2_rvc`` downloaded elsewhere):
this package reads local files only and imports no ``transformers``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..models.slm_convert import convert_checkpoint_directory
from ..utils.tensorfile import write_safetensors


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", required=True,
                    help="local checkpoint directory")
    ap.add_argument("--out", required=True)
    ap.add_argument("--layers", type=int, default=None,
                    help="encoder layers to keep (default: all)")
    args = ap.parse_args(argv)
    flat = convert_checkpoint_directory(args.model, gated=False,
                                        n_layers=args.layers)
    write_safetensors(args.out, flat)
    print(f"wrote {len(flat)} tensors -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
