"""Completed warm-started MPC solves (lane steps) over the whole window,
all lanes, per second of the window (host clock)."""


def read(run):
    return run["solves"] / run["window_s"]
