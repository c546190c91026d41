"""Share of the traced window in which no kernel, copy or set ran on the
card: 1 - (union of their intervals) / window."""

from benchmark import readers


def read(run):
    return readers.idle_pct(run)
