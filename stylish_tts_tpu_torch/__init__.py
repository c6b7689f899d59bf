"""PyTorch/CUDA port of stylish-tts-tpu (synthesis path).

Imports torch, numpy and the stdlib only; never the JAX package.
"""
