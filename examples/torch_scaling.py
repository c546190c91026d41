"""Horizon race on the port (the counterpart of ``examples/scaling.py`` and
the reference's ``scaling.jl``: server_heat nx = 50, d = 2, N = 3..15, tol
1e-3, a per-solver cutoff).

Per horizon, cold solves from x0 drawn from ``default_rng(0)`` (one draw a
horizon, as the JAX script draws them), each timed:

* ``spock`` and ``cp``: the port's ``Solver`` in float32 on the card.
  nx = 50 is above the node body's 32 (``sweep_kernels.node_fits``), so
  SPOCK runs the fused step on the element instances of the step kernels
  (#7 ``sp_step_fused`` and #6 ``sp_step_backtrack``, one launch each per
  iteration) and CP runs ``cp_sweep_fused`` (#2) on the sweep kernels'
  element body; each row carries its launches and its path flags (the
  bodies in ``sweep_body`` and ``step_body``).
  A 2-iteration solve ahead of each timed one takes the first launches;
* ``native_sp`` and ``native_cp``: the native C++ solver, float64, one
  core;
* ``admm``: the sparse conic ADMM oracle at the race tolerance.

A solver whose solve takes longer than 150 s races no longer horizon.  The
s_1 cross-check: every converged solver's objective within C tol (1 +
|s_1*|) (C = 50) of the native float64 SuperMann
solve at tol 1e-6, which runs in a worker process per horizon beside the
race (not timed as part of it); an oracle that does not converge is
reported by its own ``converged`` flag and checks nothing.  A mismatch
exits non-zero after the report is written.

    python examples/torch_scaling.py [--cpu] [--nx 50] [--nmax 15]
        [--plot] [--out-dir examples/output]

Writes ``torch_scaling.json`` after every horizon (with ``reduced`` where
the horizons raced fall short of the JAX script's 3..15) and, with ``--plot``,
``torch_scaling.png`` (``--plot-only``: from the JSON already in
``--out-dir``, e.g. written on a machine without matplotlib).  Small size
for the CPU: ``--cpu --nx 4 --nmax 4``.
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import concurrent.futures
import json
import multiprocessing
import time

import numpy as np
import torch

OUT_DIR = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "output")
NMIN, NMAX = 3, 15  # the JAX script's horizons
ORACLE = "oracle_native_sp_1e-6"
CUTOFF_S = 150.0  # a solver slower than this races no longer horizon
# the s_1 bound's multiple of tol: solvers stop on their residual, and at
# tol 1e-3 the objective lands ~10 tol from the optimum, while a wrong cone
# or sign shows O(1) gaps
OBJ_C = 50.0


def _spec(N, nx):
    from spock_tpu_torch.models import server_heat

    return server_heat.make_spec(N=N, nx=nx, d=2)


def oracle_solve(N, nx, x0, tol):
    """The s_1 oracle: native float64 SuperMann at tol min(1e-6, tol)."""
    from spock_tpu_torch.baselines import native

    t0 = time.perf_counter()
    out = native.NativeSolver(_spec(N, nx)).solve(
        x0, tol=min(1e-6, tol), max_iter=20_000, warm_start=False,
        algorithm="spock")
    return dict(N=N, alg=ORACLE, wall_s=time.perf_counter() - t0,
                iters=int(out["iterations"]),
                converged=bool(out["converged"]),
                objective=float(out["s"][0]))


def plot(payload, out_dir) -> str:
    """The PNG of wall time per solve against the horizon, by solver."""
    from plotting import SERIES, new_axes

    from spock_tpu_torch.utils import runinfo

    cfg, rows = payload["config"], payload["rows"]
    fig, ax = new_axes(
        f"Cold solves vs horizon, the port (server_heat nx={cfg['nx']}, "
        f"tol={cfg['tol']:g})",
        "horizon N", "wall time per solve [s]")
    styles = {
        "spock": SERIES["spock"],
        "cp": SERIES["cp"],
        "native_sp": {"color": "#7b3294", "ls": "--",
                      "label": "native C++ SPOCK (f64)"},
        "native_cp": {"color": "#c2a5cf", "ls": "--",
                      "label": "native C++ CP (f64)"},
        "admm": {"color": "#008837", "ls": ":",
                 "label": "sparse conic ADMM (f64)"},
    }
    for alg, s in styles.items():
        pts = [(r["N"], r["wall_s"]) for r in rows if r["alg"] == alg]
        if pts:
            ax.semilogy([p[0] for p in pts], [p[1] for p in pts],
                        color=s["color"], ls=s["ls"], lw=2, marker="o", ms=4,
                        label=s["label"])
    ax.legend(fontsize=9, frameon=False)
    return runinfo.save_figure(fig, out_dir, "torch_scaling.png")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--nx", type=int, default=50)
    ap.add_argument("--nmin", type=int, default=NMIN)
    ap.add_argument("--nmax", type=int, default=NMAX)
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--oracle-workers", type=int, default=3)
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--plot-only", action="store_true",
                    help="draw the PNG from the JSON in --out-dir, run "
                    "nothing")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args()
    if args.plot_only:
        with open(_os.path.join(args.out_dir, "torch_scaling.json")) as f:
            print(json.dumps({"png": plot(json.load(f), args.out_dir)}))
        return

    from spock_tpu_torch import build
    from spock_tpu_torch.baselines import admm_ref, native
    from spock_tpu_torch.solver import Solver
    from spock_tpu_torch.utils import runinfo

    device = runinfo.device(args.cpu)
    dtype = torch.float32
    rng = np.random.default_rng(0)
    horizons = list(range(args.nmin, args.nmax + 1))
    # one draw a horizon, in the JAX script's order
    x0s = {N: rng.uniform(-0.1, 0.1, args.nx) for N in horizons}
    rows, mismatches = [], []
    dropped = set()

    def save(done):
        """The report so far (written after every horizon, so that a run
        stopped early keeps what it finished; ``reduced`` names the
        horizons not raced)."""
        payload = dict(
            config=dict(nx=args.nx, d=2, tol=args.tol, cutoff_s=CUTOFF_S,
                        nmin=args.nmin, nmax=args.nmax, dtype=str(dtype)),
            **runinfo.environment(device), rows=rows,
            dropped=sorted(dropped),
            objective_cross_check=dict(bound="C*tol*(1+|s1*|)",
                                       C=OBJ_C, oracle=ORACLE,
                                       mismatches=mismatches))
        if (args.nmin, done) != (NMIN, NMAX):
            payload["reduced"] = dict(horizons=[args.nmin, done],
                                      jax_script=[NMIN, NMAX])
        return runinfo.write_json(args.out_dir, "torch_scaling.json", payload)
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=args.oracle_workers,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        oracles = {N: pool.submit(oracle_solve, N, args.nx, x0s[N],
                                  args.tol) for N in horizons}
        for N in horizons:
            spec = _spec(N, args.nx)
            data, meta = build(spec, dtype=dtype, device=device)
            x0 = x0s[N]
            objs = {}

            def rec(alg, dt, iters, conv, obj, **extra):
                rows.append(dict(N=N, nodes=meta.tree.n, alg=alg, wall_s=dt,
                                 iters=int(iters), converged=bool(conv),
                                 **extra))
                if conv:
                    rows[-1]["objective"] = float(obj)
                    objs[alg] = float(obj)
                print(json.dumps(rows[-1]), flush=True)
                if dt > CUTOFF_S:
                    dropped.add(alg)

            for alg in ("spock", "cp"):
                if alg in dropped:
                    continue
                Solver(data, meta, algorithm=alg, max_iter=2,
                       device=device).solve(x0, tol=args.tol)
                solver = Solver(data, meta, algorithm=alg, device=device)
                runinfo.reset_launches()
                if device.type == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = solver.solve(x0, tol=args.tol)
                s1 = float(res.z.s[0])
                rec(alg, time.perf_counter() - t0, res.iterations,
                    res.converged, s1, paths=runinfo.path_flags(data, meta),
                    launches={k: c for k, c in runinfo.launches().items()
                              if c})

            for alg, nat_alg in (("native_sp", "spock"), ("native_cp", "cp")):
                if alg in dropped:
                    continue
                nsol = native.NativeSolver(spec)
                t0 = time.perf_counter()
                out = nsol.solve(x0, tol=args.tol,
                                 max_iter=5000 if nat_alg == "cp" else 1000,
                                 warm_start=False, algorithm=nat_alg)
                rec(alg, time.perf_counter() - t0, out["iterations"],
                    out["converged"], out["s"][0])

            if "admm" not in dropped:
                t0 = time.perf_counter()
                out = admm_ref.solve(spec, x0, tol=args.tol,
                                     max_iter=100_000)
                rec("admm", time.perf_counter() - t0, out["iterations"],
                    out["converged"], out["s"][0])

            # the s_1 cross-check against the float64 oracle
            oracle = oracles[N].result()
            rows.append(oracle)
            print(json.dumps(oracle), flush=True)
            if oracle["converged"]:
                s1_star = oracle["objective"]
                bound = OBJ_C * args.tol * (1.0 + abs(s1_star))
                for alg, val in objs.items():
                    if abs(val - s1_star) > bound:
                        mismatches.append(dict(N=N, alg=alg, objective=val,
                                               oracle=s1_star, bound=bound))
                        print(json.dumps({"OBJECTIVE_MISMATCH":
                                          mismatches[-1]}), flush=True)
            save(done=N)

    path = save(done=horizons[-1])
    print(json.dumps({"wrote": path, "mismatches": len(mismatches)}),
          flush=True)

    if args.plot:
        with open(path) as f:
            print(json.dumps({"png": plot(json.load(f), args.out_dir)}),
                  flush=True)

    if mismatches:
        raise SystemExit(f"{len(mismatches)} objective mismatches")


if __name__ == "__main__":
    main()
