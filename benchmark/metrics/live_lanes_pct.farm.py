"""Share of the lane-iterations of the window's farm iterations in which
the lane was solving: the solves' iterations over lanes times farm
iterations (a lane that has done its run's steps waits for the run's
slowest)."""


def read(run):
    n = run.get("farm_iterations")
    return 100.0 * run["solve_iterations"] / (run["lanes"] * n) if n else None
