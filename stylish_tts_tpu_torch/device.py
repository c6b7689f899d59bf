"""Device selection and the numeric settings of the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The card unless the caller names another device.

    Raises when CUDA is asked for (explicitly or by default) and missing:
    the port never falls back to the CPU on its own."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        # the spectral chain and the convs run in full f32, as the JAX
        # package forces HIGHEST precision there; cuDNN defaults to TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device
