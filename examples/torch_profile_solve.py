"""One timed solve on the port (the counterpart of
``examples/profile_solve.py`` and the reference's ``main_profiling.jl``):
SPOCK on the 2-state car model, N = 10, d = 2, tol 1e-3, float32, x0 =
(0.1, 0.1), timed with ``utils.profiling.time_fn`` (median of 3 after a
warm-up solve).  ``--trace DIR`` profiles one more solve through
``utils.profiling.trace`` (``torch.profiler``; a Chrome trace,
``DIR/trace.json``) and records its top kernels.

    python examples/torch_profile_solve.py [--cpu] [--trace DIR]
        [--out-dir examples/output]

Writes ``torch_profile_solve.json``.  Small size for the CPU: ``--cpu
--horizon 3``.
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json

import numpy as np
import torch

OUT_DIR = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "output")
TOP_KERNELS = 8


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--trace", type=str, default=None)
    ap.add_argument("--horizon", type=int, default=10)
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args()

    from spock_tpu_torch import build
    from spock_tpu_torch.models import car
    from spock_tpu_torch.solver import Solver
    from spock_tpu_torch.utils import profiling, runinfo

    device = runinfo.device(args.cpu)
    spec = car.make_spec(N=args.horizon, d=2)
    data, meta = build(spec, dtype=torch.float32, device=device)
    solver = Solver(data, meta, algorithm="spock", device=device)
    x0 = np.array([0.1, 0.1])

    wall = profiling.time_fn(lambda: solver.solve(x0, tol=args.tol))
    runinfo.reset_launches()
    res = solver.solve(x0, tol=args.tol)
    iters = int(res.iterations)
    out = dict(
        model=f"car N={args.horizon} d=2", tol=args.tol, dtype="float32",
        **runinfo.environment(device), paths=runinfo.path_flags(data, meta),
        iters=iters, converged=bool(res.converged), objective=float(
            res.z.s[0]), wall_s=wall, ms_per_iteration=1e3 * wall / iters,
        launches=runinfo.launches())
    if args.trace:
        with profiling.trace(args.trace) as prof:
            solver.solve(x0, tol=args.tol)
        attr = "device_time_total" if device.type == "cuda" \
            else "cpu_time_total"
        top = sorted(prof.key_averages(), key=lambda e: -getattr(e, attr))
        out["trace"] = dict(
            file=_os.path.join(args.trace, "trace.json"), by=attr,
            top=[dict(name=e.key, calls=e.count, us=getattr(e, attr))
                 for e in top[:TOP_KERNELS]])
    path = runinfo.write_json(args.out_dir, "torch_profile_solve.json", out)
    print(json.dumps(dict(out, wrote=path), indent=1), flush=True)


if __name__ == "__main__":
    main()
