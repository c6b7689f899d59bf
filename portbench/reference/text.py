"""Phoneme/character -> token-id mapping.

pad + punctuation + latin + IPA symbols map to contiguous ids, in the same
order as the reference TextCleaner, so ids match its checkpoints; unknown
characters are logged and dropped.  Batches are bracketed and padded by
``export/infer.py:Synthesizer.encode_batch``.
"""

from __future__ import annotations

import logging
from typing import List

from .config import SymbolConfig

logger = logging.getLogger(__name__)


class TextCleaner:
    def __init__(self, symbols: SymbolConfig | None = None):
        symbols = symbols or SymbolConfig()
        inventory = (
            [symbols.pad]
            + list(symbols.punctuation)
            + list(symbols.letters)
            + list(symbols.letters_ipa)
        )
        self.word_index_dictionary = {s: i for i, s in enumerate(inventory)}
        self.n_symbols = len(inventory)
        self.pad_id = 0

    def __call__(self, text: str) -> List[int]:
        ids = []
        for char in text:
            idx = self.word_index_dictionary.get(char)
            if idx is None:
                logger.error("Unknown symbol %r dropped from: %s", char, text)
            else:
                ids.append(idx)
        return ids
