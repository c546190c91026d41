"""Profiling helpers: the program's host spans, a ``torch.profiler`` trace
and a median wall time.

``span(name)`` marks a part of the program on the host.  It costs one
check of the profiler's state while no profiler records (a shared null
context is returned); while one records, the span is a ``record_function``
range on the profiler's clock, in the same trace as the kernels, and its
count, total and self time (total less the time its child spans cover) are
added to an in-memory table, read by ``spans()``.  So the table holds
exactly the profiled windows of the process.

The JAX package's ``hlo_collective_stats`` (collectives counted in XLA's
optimised HLO text) has no counterpart: the port compiles no HLO, and its
one-card paths run no collective.
"""

from __future__ import annotations

import contextlib
import functools
import time
from pathlib import Path

import torch

_NULL = contextlib.nullcontext()
# whether a profiler records in this process (about 0.2 us a call;
# record_function costs about 10 us even while none records)
recording = torch._C._autograd._profiler_enabled
# name -> [count, total ns, self ns] of the spans closed while profiling
_TABLE: dict = {}
# the spans open, innermost last (the program's host code runs on one
# thread)
_STACK: list = []


class _Span:
    __slots__ = ("name", "rf", "t0", "child")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.child = 0
        _STACK.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self.t0
        _STACK.pop()
        if _STACK:
            _STACK[-1].child += dur
        row = _TABLE.setdefault(self.name, [0, 0, 0])
        row[0] += 1
        row[1] += dur
        row[2] += dur - self.child
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A span of the program named ``name``: a null context unless a
    profiler records, else a ``record_function`` range whose times go to
    the table of ``spans``."""
    return _Span(name) if recording() else _NULL


def spanned(name: str):
    """Decorator: each call of the function is a ``span`` named ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def spans() -> dict:
    """{name: [count, total ns, self ns]} of the spans closed while a
    profiler recorded, since the last ``reset_spans`` (a copy)."""
    return {k: list(v) for k, v in _TABLE.items()}


def reset_spans() -> None:
    _TABLE.clear()

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
