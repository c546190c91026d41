"""Backtracking trials a farm iteration: the delta of the device counter
spstep.retrials() over the window, over its farm iterations."""


def read(run):
    n = run.get("farm_iterations")
    return run["retrials"] / n if n else None
