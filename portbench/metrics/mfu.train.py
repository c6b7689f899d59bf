"""The whole step's (or batch's) model FLOP, each type at its peak, as
least time over the traced window (``counts/flops.py``)."""

from portbench.readers import mfu


def read(seg, run):
    return mfu(seg)
