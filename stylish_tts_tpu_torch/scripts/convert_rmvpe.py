"""Convert the published RMVPE pitch-model checkpoint to the flat flax
names that ``pitch --method rmvpe --rmvpe-weights`` reads.

    python -m stylish_tts_tpu_torch.scripts.convert_rmvpe rmvpe.pt out.safetensors

The input is the torch E2E0 ``state_dict`` as ``.safetensors``, ``.pt`` or
``.bin``; the output holds its params and, under ``__batch_stats__/``, its
batch norms' running statistics.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..export.import_torch import load_state_dict_file, write_converted
from ..models.torch_convert import convert_rmvpe


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", help="torch state dict (.safetensors/.pt/.bin)")
    ap.add_argument("dst", help="converted .safetensors")
    args = ap.parse_args(argv)
    params, stats = convert_rmvpe(load_state_dict_file(args.src))
    write_converted(args.dst, params, stats)
    print(f"wrote {args.dst} ({len(params)} params, {len(stats)} batch "
          f"stats)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
