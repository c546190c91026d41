"""Milliseconds a SuperMann iteration in the loop: step time over the
iterations of the window's solves (host clock)."""

from benchmark import readers


def read(run):
    return readers.iter_ms(run, "step_s")
