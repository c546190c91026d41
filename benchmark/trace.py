"""The traced window: ``torch.profiler`` over the window of a ``--trace 1``
run, reduced to what the per-layer metrics read.

The device's activity is the union of the intervals of its kernels, copies
and sets (the profiler sees the kernels of CUDA-graph replays); ``busy_s``
is its length and ``window_s`` the traced window's.  ``breakdown`` lists the
device operations that took most time and the longest idle stretches of the
device, each named by the innermost host-side span or operator that was
open at its middle (the harness's own spans, ``bench.*``, mark the calls
into the program's layers).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "python_function")


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(events, window_us: float, t0_us: float | None = None):
    """Reduce chrome-trace events (``ts`` and ``dur`` in microseconds) to
    busy seconds, kernel seconds and launches by name, and the breakdown."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and e.get("ph") == "X"]
    host = [e for e in events if e.get("cat") in HOST_CATS
            and e.get("ph") == "X"]
    by_name: dict = {}
    for e in dev:
        t, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (t + e["dur"] * 1e-6, n + 1)
    busy = _union((e["ts"], e["ts"] + e["dur"]) for e in dev)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    # idle stretches between device activity, inside the window
    if t0_us is None:
        t0_us = min((e["ts"] for e in host + dev), default=0.0)
    edges = [t0_us] + [x for iv in busy for x in iv] + [t0_us + window_us]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    host.sort(key=lambda e: e["ts"])
    starts = [h["ts"] for h in host]
    idle: dict = {}
    for s, e in gaps[:5000]:
        mid = 0.5 * (s + e)
        # the innermost open span is the latest to start of those open
        name = "host: no span open"
        for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if host[j]["ts"] + host[j]["dur"] >= mid:
                name = host[j]["name"]
                break
        idle[name] = idle.get(name, 0.0) + (e - s) * 1e-6
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return dict(
        busy_s=busy_s, window_s=window_us * 1e-6,
        kernels={k: dict(seconds=t, launches=n)
                 for k, (t, n) in by_name.items()},
        breakdown=dict(
            device_ops=[[k[:120], t] for k, (t, _) in top_ops],
            idle_gaps=[[k[:120], t] for k, t in
                       sorted(idle.items(), key=lambda kv: -kv[1])[:10]]),
    )


class Tracer:
    """Profile the window (CPU and CUDA activity); ``reduce`` reads the
    trace, written to a file under ``TMPDIR`` and removed."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.window_s = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._sync = (lambda: torch.cuda.synchronize(self.device)
                      if self.device.type == "cuda" else None)
        self._sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        return False

    def reduce(self) -> dict:
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        # the window starts at the first of the harness's window spans
        marks = [e["ts"] for e in events
                 if e.get("name", "").startswith("bench.")]
        t0 = min(marks) if marks else None
        return reduce_events(events, self.window_s * 1e6, t0)
