"""Text front end: normalisation, sentence splitting and G2P to the IPA of
the symbol inventory.  The port's copy of the JAX package's
``textfrontend/``: host code, pure Python and numpy (the homograph
classifier's logistic regression), with its weights in ``data/``."""

from .normalize import normalize_text, number_to_words, split_sentences  # noqa: F401
from .g2p import G2P, to_espeak  # noqa: F401
