"""The harness: one run of one cell, found by name.

A cell ``<config>.<mix>`` of ``BENCHMARK.json`` names a configuration,
``benchmark/configs/<config>.json`` (its shapes, precision, tolerance and
plain reference), and a traffic mix, ``benchmark/mixes/<mix>.json`` (the
parameters of one of the general drivers in ``benchmark/drivers``).  Each
metric is a reader of its own, ``benchmark/metrics/<metric>.py`` with a
``read(run) -> float | None``; the limits of the comparison that decides
``correct`` are ``benchmark/limits/<cell>.json``.  A new configuration, mix,
cell or metric is new files and new entries, never an edit.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

# modules that must not be loaded in the process that prints a result:
# the JAX stack and the JAX package (top-level names compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "spock_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: dict, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end metrics with
    --trace 0, its per-layer metrics with --trace 1.  A metric with a
    ``workloads`` key belongs to those cells; a per-layer metric without
    one to every cell that reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell["name"] in m.get("workloads", [cell["name"]])
            and ("workloads" in m or m["moves"] in names)]


def reader(root: Path, name: str):
    """The ``read`` function of ``benchmark/metrics/<name>.py``."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def device_info(torch, device, count: int) -> dict:
    if device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=count,
                    memory_peak_bytes=0)
    info = dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                count=count,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated(device)))
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(out.stdout.strip())
    except (OSError, ValueError, subprocess.TimeoutExpired):
        info["power_limit_w"] = None
    return info


def quantile(values, q: float) -> float:
    """The q-quantile by linear interpolation between closest ranks."""
    v = sorted(values)
    pos = (len(v) - 1) * q
    lo, hi = math.floor(pos), math.ceil(pos)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def run_cell(root: Path, cell_name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: float | None = None,
             log=None) -> dict:
    """One run of the cell: set-up, the window of ``seconds``, the check of
    what the window produced, the cell's metrics.  Returns the result line's
    object.  ``t_start``: the process's start on the host clock (set-up
    counts from it)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    root = Path(root)
    bench = load_json(root / "BENCHMARK.json")
    cell = find_cell(bench, cell_name)
    config = load_json(root / "benchmark" / "configs" /
                       f"{cell['config']}.json")
    mix = load_json(root / "benchmark" / "mixes" / f"{cell['traffic']}.json")
    limits = load_json(root / "benchmark" / "limits" / f"{cell_name}.json")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    # the configuration's precision: float32 matmuls are true float32
    torch.backends.cuda.matmul.allow_tf32 = bool(config.get("tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(config.get("tf32", False))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    drv = driver(mix["driver"])
    run = dict(cell=cell, config=config, mix=mix, seed=seed, device=dev,
               seconds=seconds, trace=None)
    state = drv.setup(run, log)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    run["setup_s"] = time.perf_counter() - t_start
    log(f"[bench] set-up {run['setup_s']:.3f} s")
    if trace:
        from . import trace as tr

        with tr.Tracer(dev) as tracer:
            drv.window(run, state, log)
        run["trace"] = tracer.reduce()
    else:
        drv.window(run, state, log)
    info = device_info(torch, dev, cell["chips"])
    if trace and run["trace"] is not None:
        info["busy_s"] = run["trace"]["busy_s"]
        info["window_s"] = run["trace"]["window_s"]
    numbers = drv.check(run, state, limits, log)
    del state
    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        value = reader(root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(v <= lim for v, lim in numbers.values())
    for name, (v, lim) in numbers.items():
        log(f"[check] {name} {v!r} limit {lim!r}")
    out = {"correct": correct, "attempted": run["attempted"],
           "failed": run["failed"], "metrics": metrics, "device": info}
    if trace and run["trace"] is not None:
        out["breakdown"] = run["trace"]["breakdown"]
    out["check"] = {k: {"value": v, "limit": lim}
                    for k, (v, lim) in numbers.items()}
    return out
