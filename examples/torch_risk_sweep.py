"""Risk-measure sweep on a fixed tree on the port (BASELINE config 3; the
counterpart of ``examples/risk_sweep.py``): risk-neutral, AV@R at alpha
0.99, 0.9, 0.5 and 0.1, TV(0.3) and EVaR(0.5) on server_heat d = 3,
nx = nu = 6, N = 12 (265,720 nodes), p and x0 from ``default_rng(0)`` as in
the JAX script; one cold single-lane SuperMann ``Solver`` solve per measure
(at most 4000 iterations) to tol 1e-4, float32.

Each row runs on its default path: the step kernels (AV@R, TV and
risk-neutral: one block for the one lane) or, for EVaR, whose exponential
cone no kernel covers, the composed path with the plain prox_h*.  Each row
reports its objective, iterations, wall seconds and the kernel launches of
its solve.  The kernels are built before the first row, and each row's
timed solve follows a 2-iteration solve (first launches, constants).
``--jobs K`` solves K rows at once in processes of their own (for the CPU;
their wall times then share the machine).

    python examples/torch_risk_sweep.py [--cpu] [--small] [--jobs K]
        [--out-dir examples/output]

``--small``: N = 4 (40 nodes).  Writes ``torch_risk_sweep_n12.json`` or
``torch_risk_sweep_small.json``.
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import concurrent.futures
import dataclasses
import json
import multiprocessing
import time

import numpy as np
import torch

OUT_DIR = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "output")
MAX_ITER = 4000


def sweep(p, nnl):
    """The seven measures in the JAX script's order."""
    from spock_tpu_torch import risks

    out = [("risk_neutral", risks.risk_neutral(p, nnl))]
    for alpha in [0.99, 0.9, 0.5, 0.1]:
        out.append((f"avar[{alpha}]", risks.avar(p, alpha, nnl)))
    out.append(("tv[0.3]", risks.total_variation(p, 0.3, nnl)))
    out.append(("evar[0.5]", risks.evar(p, 0.5, nnl)))
    return out


def solve_row(name, spec, x0, tol, dtype, device):
    """One row: a 2-iteration solve (first launches, constants), then the
    timed cold solve with the launch counts set to 0 just before."""
    from spock_tpu_torch import build
    from spock_tpu_torch.solver import Solver
    from spock_tpu_torch.utils import runinfo

    device = torch.device(device)
    if device.type == "cpu":
        torch.set_num_threads(1)
    data, meta = build(spec, dtype=dtype, device=device)
    Solver(data, meta, algorithm="spock", max_iter=2,
           device=device).solve(x0, tol=tol)
    solver = Solver(data, meta, algorithm="spock", max_iter=MAX_ITER,
                    device=device)
    runinfo.reset_launches()
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver.solve(x0, tol=tol)
    objective = float(res.z.s[0])
    wall = time.perf_counter() - t0
    return dict(
        risk=name, objective=objective, iters=int(res.iterations),
        converged=bool(res.converged), wall_s=wall,
        ms_per_iteration=1e3 * wall / max(int(res.iterations), 1),
        paths=runinfo.path_flags(data, meta),
        launches={k: c for k, c in runinfo.launches().items() if c})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--small", action="store_true", help="N=4 quick mode")
    ap.add_argument("--nx", type=int, default=6)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--jobs", type=int, default=1,
                    help="rows solved at once, each in a process of its own "
                    "(their wall times then share the machine)")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args()

    from spock_tpu_torch import risks
    from spock_tpu_torch.models import server_heat
    from spock_tpu_torch.utils import runinfo

    device = runinfo.device(args.cpu)
    if device.type == "cuda":
        from spock_tpu_torch.ops import _build

        _build.build_all()
    dtype = torch.float32
    N, d = (4, 3) if args.small else (12, 3)
    base = server_heat.make_spec(N=N, nx=args.nx, d=d)
    nnl = base.tree.n_nonleaf
    rng = np.random.default_rng(0)
    p = risks.rand_probvec(rng, d)
    x0 = rng.uniform(-0.5, 0.5, args.nx)
    jobs = [(name, dataclasses.replace(base, risk=risk), x0, args.tol,
             dtype, str(device)) for name, risk in sweep(p, nnl)]
    if args.jobs > 1:
        with concurrent.futures.ProcessPoolExecutor(
                max_workers=args.jobs,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            rows = list(pool.map(solve_row, *zip(*jobs)))
    else:
        rows = [solve_row(*job) for job in jobs]
    for row in rows:
        print(json.dumps(row), flush=True)

    payload = dict(
        config=dict(N=N, d=d, nx=args.nx, tol=args.tol, dtype=str(dtype),
                    n_nodes=int(base.tree.n), max_iter=MAX_ITER,
                    jobs=args.jobs),
        **runinfo.environment(device), rows=rows,
        note=(f"BASELINE config 3 on the port: risk-neutral + AV@R grid + TV "
              f"+ EVaR on the branching-{d} N={N} tree ({base.tree.n} "
              f"nodes), {dtype}, SPOCK, cold single-lane solves to "
              f"tol={args.tol}"))
    name = "torch_risk_sweep_small.json" if args.small \
        else "torch_risk_sweep_n12.json"
    path = runinfo.write_json(args.out_dir, name, payload)
    print(json.dumps({"wrote": path}), flush=True)


if __name__ == "__main__":
    main()
