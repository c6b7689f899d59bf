"""100 x the card's idle time while the host was inside ``synth.upload``,
over the traced window (``portbench/spans.py``)."""

from portbench.spans import UPLOAD, idle_pct


def read(seg, run):
    return idle_pct(seg, [UPLOAD])
