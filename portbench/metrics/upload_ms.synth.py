"""Host milliseconds inside the program's ``synth.upload`` spans (the
pinned copies of a batch's tokens, lengths and durations) per traced batch
(``portbench/spans.py``)."""

from portbench.spans import UPLOAD, per_unit_ms


def read(seg, run):
    return per_unit_ms(seg, UPLOAD)
