"""What the metric readers share: each ``metrics/<name>.py`` is a few lines
over these.  A reader returns None where its run has nothing to read (no
trace, no such counter); the harness then leaves the metric out."""

from __future__ import annotations

from . import roofline

STEP_KERNELS = ("sp_step_kernel", "sp_backtrack_kernel")


def kernels(run, marker: str) -> tuple:
    """(seconds, launches) of the traced kernels whose name holds
    ``marker``; None without a trace or where none ran."""
    tr = run.get("trace")
    if not tr:
        return None
    sel = [k for name, k in tr["kernels"].items() if marker in name]
    if not sel:
        return None
    return (sum(k["seconds"] for k in sel), sum(k["launches"] for k in sel))


def step_roofline_pct(run):
    """The step kernels' share of their roofline over the traced window:
    the least time the launches' bytes and operations need at the card's
    peaks (``roofline``), over the time the profiler saw them take.  A
    launch counts the lanes that were solving: in a farm, the window's
    solve iterations (lane-launches) spread over its launches, since a lane
    that has done its run's steps does no work."""
    step, back = kernels(run, STEP_KERNELS[0]), kernels(run, STEP_KERNELS[1])
    if step is None or step[0] <= 0:
        return None
    shape = run["config"]["shape"]
    itemsize = 8 if run["config"]["dtype"] == "float64" else 4
    lane_launches = run.get("solve_iterations", step[1])
    least = roofline.bound_s(*roofline.step_launch(shape, lane_launches, 0.0,
                                                   itemsize))
    secs = step[0]
    if back is not None:
        nb, ops = roofline.backtrack_launches(
            shape, lane_launches / step[1], back[1], run["retrial_lanes"],
            run["retrials"], itemsize)
        least += roofline.bound_s(nb, ops)
        secs += back[0]
    return 100.0 * least / secs


def idle_pct(run):
    tr = run.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def iters_per_solve(run):
    if run.get("solves"):
        if "solve_iterations" in run:
            return run["solve_iterations"] / run["solves"]
        return sum(run["iterations"]) / run["solves"]
    return None


def iter_ms(run, times_key):
    n = sum(run["iterations"])
    return 1e3 * sum(run[times_key]) / n if n else None
