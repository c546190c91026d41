"""Milliseconds a farm iteration: the window over the farm iterations it
counted (run.counted)."""


def read(run):
    n = run.get("farm_iterations")
    return 1e3 * run["window_s"] / n if n else None
