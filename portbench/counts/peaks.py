"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W power limit): f32 outside the tensor cores, bf16 on them, HBM3."""

PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time of a launch: its bytes at the memory's peak or its
    FLOP at the peak of ``dtype``, whichever is longer."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)
