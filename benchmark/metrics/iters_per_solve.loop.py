"""SuperMann iterations a solve over the window's solves."""

from benchmark import readers


def read(run):
    return readers.iters_per_solve(run)
