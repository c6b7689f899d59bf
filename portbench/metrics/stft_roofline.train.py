"""The STFT kernels' share of their roofline over the traced segment:
the launches' least time (FFT formula and bytes, ``counts/stft.py``) over
the device time of ``stft_fft_kernel`` and ``stft_dft_kernel``."""

from portbench.readers import stft_roofline


def read(seg, run):
    return stft_roofline(seg)
