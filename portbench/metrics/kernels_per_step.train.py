"""Kernel launches the device ran per traced train step: the host's launch
burden (memory copies and sets left out)."""

from portbench.readers import kernels_per_unit


def read(seg, run):
    return kernels_per_unit(seg)
