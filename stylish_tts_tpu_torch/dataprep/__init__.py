"""Data preparation from raw audio: a book's chapters into a dataset
(``book.py``), the F0 cache (``pitch.py``, YIN) and the alignment cache
(``align_text.py``, the CTC aligner)."""
