"""Mean host duration of the program's ``train.step`` spans in the traced
segment: how long the host takes to enqueue one step (``portbench/
spans.py``)."""

from portbench.readers import host_mean_ms
from portbench.spans import STEP, durations


def read(seg, run):
    return host_mean_ms(durations(seg, STEP))
