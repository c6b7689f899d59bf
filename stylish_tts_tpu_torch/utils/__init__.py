"""Helpers of the port: the safetensors format, a synthetic dataset and
the down-scaled model config of the tests."""
