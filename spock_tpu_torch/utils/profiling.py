"""Profiling helpers: a ``torch.profiler`` trace, a timer that waits for the
card, and a median wall time.

The JAX package's ``hlo_collective_stats`` (collectives counted in XLA's
optimised HLO text) has no counterpart: the port compiles no HLO, and its
one-card paths run no collective.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch

# traces go under the checkout's build/ directory unless told otherwise
TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "trace"


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir=None):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where there
    is a card) and write a Chrome trace, viewable in Perfetto, to
    ``logdir/trace.json``.  Yields the profiler: ``key_averages()`` gives
    the time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    logdir = Path(logdir or TRACE_DIR)
    logdir.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(str(logdir / "trace.json"))


class Timer:
    """Wall-clock timer that waits for the card's queued work.

    with Timer() as t:
        out = fn(x)
        t.block(out)
    print(t.elapsed)       # seconds on the host's clock
    print(t.device_ms)     # ms between CUDA events (None without a card)
    """

    def __enter__(self):
        self.elapsed = None
        self.device_ms = None
        self._events = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        self.t0 = time.perf_counter()
        return self

    def block(self, out):
        _sync()
        return out

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record()
            self._events[1].synchronize()
            self.device_ms = self._events[0].elapsed_time(self._events[1])
        self.elapsed = time.perf_counter() - self.t0
        return False


def time_fn(fn, *args, iters: int = 3, warmup: int = 1) -> float:
    """Median wall time of ``fn(*args)`` after ``warmup`` calls (kernel
    builds and first launches), waiting for the card after each call."""
    for _ in range(warmup):
        fn(*args)
        _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
