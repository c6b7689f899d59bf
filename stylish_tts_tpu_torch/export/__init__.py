"""Inference artifact loading and synthesis."""
