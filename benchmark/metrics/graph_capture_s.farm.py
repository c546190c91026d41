"""Seconds the farm driver spent capturing its CUDA graphs and running
their throwaway warm-up iterations during set-up (run.capture_s +
run.warmup_s)."""


def read(run):
    st = run.get("setup_stats")
    return st["capture_s"] + st["warmup_s"] if st else None
