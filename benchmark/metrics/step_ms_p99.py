"""The 99th percentile of the window's receding-horizon steps (solve and
plant update, ending in a synchronize), by the host clock, over every step
of the window's whole runs: with ~150 steps, between the slowest two, the
steps that start a run from a fresh state."""

from benchmark.core import quantile


def read(run):
    return 1e3 * quantile(run["step_s"], 0.99)
