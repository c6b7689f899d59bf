"""Entry points of the port that lie outside synthesis and training."""
