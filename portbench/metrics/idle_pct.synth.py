"""100 x (1 - the union of device operations' intervals over the traced
window)."""

from portbench.readers import idle_pct


def read(seg, run):
    return idle_pct(seg)
