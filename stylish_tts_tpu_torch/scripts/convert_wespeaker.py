"""Convert the wespeaker vblinkp speaker checkpoint (the voxblink2
SimAM-ResNet34, its bottleneck stripped) to the flat flax names that
``speaker_embedder.weights_path`` reads.

    python -m stylish_tts_tpu_torch.scripts.convert_wespeaker avg_model.pt out.safetensors

The input is a raw ``state_dict`` (``.pt``/``.bin``), a wespeaker
checkpoint dict that holds it under ``model`` or ``state_dict``, or a
``.safetensors`` export.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..export.import_torch import load_state_dict_file, write_converted
from ..models.torch_convert import convert_wespeaker


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", help="torch checkpoint (.pt/.bin/.safetensors)")
    ap.add_argument("dst", help="converted .safetensors")
    args = ap.parse_args(argv)
    params = convert_wespeaker(load_state_dict_file(args.src))
    write_converted(args.dst, params, {})
    print(f"wrote {args.dst} ({len(params)} params)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
