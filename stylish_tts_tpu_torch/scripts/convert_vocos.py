"""Convert the pretrained Vocos mel-vocoder checkpoint to the flat flax
names that ``training.vocos_weights`` reads (the ``cfm_hubert_mel``
stage's validation vocoder).

    python -m stylish_tts_tpu_torch.scripts.convert_vocos pytorch_model.bin out.safetensors

The input is the Vocos ``state_dict`` as ``.bin``, ``.pt`` or
``.safetensors``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..export.import_torch import load_state_dict_file, write_converted
from ..models.torch_convert import convert_vocos


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", help="torch state dict (.bin/.pt/.safetensors)")
    ap.add_argument("dst", help="converted .safetensors")
    args = ap.parse_args(argv)
    params = convert_vocos(load_state_dict_file(args.src))
    write_converted(args.dst, params, {})
    print(f"wrote {args.dst} ({len(params)} params)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
