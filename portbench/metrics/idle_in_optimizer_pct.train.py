"""100 x the card's idle time while the host was inside ``train.zero_grad``
or ``train.optimizer`` (AdamW, the MRD's LR multiplier read to the host,
the EMA), over the traced window (``portbench/spans.py``)."""

from portbench.spans import phase_idle_pct


def read(seg, run):
    return phase_idle_pct(seg, "optimizer")
