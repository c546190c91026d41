"""Seconds from the process's start to the window's: imports, the build,
kernel loading (and their compilation on a first run), graph capture,
warm-up (host clock)."""


def read(run):
    return run["setup_s"]
