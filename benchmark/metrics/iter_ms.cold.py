"""Milliseconds a SuperMann iteration of a cold solve: solve time over
the iterations of the window's solves (host clock)."""

from benchmark import readers


def read(run):
    return readers.iter_ms(run, "solve_s")
