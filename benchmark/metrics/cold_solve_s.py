"""Seconds a cold solve takes: the wall time of the window's cold solves
over their number (host clock); no solve is cut by the window."""


def read(run):
    return sum(run["solve_s"]) / len(run["solve_s"])
