"""The MRD's spec-conv kernels' share of their roofline over the traced
segment: forward, dgrad and wgrad launches' least time (``counts/
spec_conv.py``, bf16 peak) over the device time of ``spec_conv_fwd_kernel``,
``spec_conv_dgrad_kernel``, ``spec_conv_wgrad_kernel`` and
``sum_partials_kernel``."""

from portbench.readers import spec_conv_roofline


def read(seg, run):
    return spec_conv_roofline(seg)
