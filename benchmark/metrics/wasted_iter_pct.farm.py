"""Share of the farm iterations the window executed after its run had
finished: the rest of a run's last graph chunk (run.wasted over
run.executed)."""


def read(run):
    n = run.get("executed")
    return 100.0 * (n - run["farm_iterations"]) / n if n else None
