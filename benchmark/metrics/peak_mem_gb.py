"""Peak of torch.cuda.max_memory_allocated() over set-up and window, after
reset_peak_memory_stats() at the run's start, in GB (1e9 bytes)."""


def read(run):
    return run["peak_bytes"] / 1e9 if "peak_bytes" in run else None
