"""A checkout of the benchmark at a tiny size, for the CPU tests: the
committed harness with small configurations, mixes, limits and
``BENCHMARK.json`` entries of its own, in a directory of the test's."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

CONFIG = {
    "name": "tiny", "source": "test", "model": "server_heat",
    "reference": "server_heat",
    "shape": {"N": 3, "nx": 3, "d": 2, "p": [0.3, 0.7], "alpha": 0.95},
    "dtype": "float32", "tf32": False, "tol": 0.001, "reduced": [],
    "assumed": {},
}
MIXES = {
    "farm": {"driver": "farm", "lanes": 4, "iters_per_launch": 5,
             "run_steps": 3, "x0_half_width": 0.6, "max_run_iters": 300,
             "check_samples": 3},
    "loop": {"driver": "loop", "x0_half_width": 0.6, "run_steps": 3,
             "warmup_steps": 2, "max_steps_per_second": 400,
             "check_samples": 3},
    "cold": {"driver": "cold", "x0_half_width": 0.6, "max_solves": 4000,
             "warmup_solves": 1, "check_samples": 3},
}
LIMITS = {"farm": {"u_gap": 0.02, "plant_gap": 1e-5, "dyn_gap": 1e-5,
                   "stalled_lanes": 0},
          "loop": {"u_gap": 0.02, "plant_gap": 1e-5, "dyn_gap": 1e-5},
          "cold": {"u_gap": 0.01, "obj_gap": 0.05, "dyn_gap": 1e-5}}


def make_root(tmp: Path) -> Path:
    """A checkout at ``tmp``: BENCHMARK.json and benchmark/, with the tiny
    configuration ``tiny`` and the cells tiny.farm, tiny.loop, tiny.cold
    added as files and entries."""
    shutil.copytree(BENCH, tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp / "benchmark" / "configs" / "tiny.json").write_text(
        json.dumps(CONFIG))
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "benchmark/configs/tiny.json",
                             "reduced": [], "why": "test"})
    for mix, params in MIXES.items():
        (tmp / "benchmark" / "mixes" / f"tiny_{mix}.json").write_text(
            json.dumps(params))
        cell = f"tiny.{mix}"
        (tmp / "benchmark" / "limits" / f"{cell}.json").write_text(
            json.dumps(LIMITS[mix]))
        bench["workloads"].append({"name": cell, "config": "tiny",
                                   "traffic": f"tiny_{mix}", "chips": 1,
                                   "why": "test"})
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    e2e["warm_solves_per_s"]["workloads"].append("tiny.farm")
    e2e["step_ms_p99"]["workloads"].append("tiny.loop")
    e2e["cold_solve_s"]["workloads"].append("tiny.cold")
    for m in bench["per_layer"]:
        for c in ("farm", "loop", "cold"):
            if m["name"].endswith("." + c):
                m["workloads"].append(f"tiny.{c}")
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
