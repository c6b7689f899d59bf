"""Spectral ops and the Hopper kernels that serve them."""
