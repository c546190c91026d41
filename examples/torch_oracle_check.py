"""Three-tier oracle cross-check at the headline configuration, on the port.

The counterpart of ``examples/oracle_check.py``: the same risk-averse OCP
instances (server_heat N=10, nx=nu=20, d=2, x0 from ``default_rng(0)``)
solved by three independent code paths, with the pairwise agreement of
their root controls and objectives:

1. the port (``spock_tpu_torch``), float32 on the card: cold solves as a
   padded 1-step ``mpc.simulate_async`` farm of B = 128 lanes on the main
   path (the fused step in CUDA-graph chunks of 30 farm iterations);
2. the native C++ SuperMann solver (``baselines/native.py``), float64, tol
   1e-6;
3. the sparse conic ADMM oracle (``baselines/admm_ref.py``), float64, tol
   1e-8: another method family.

Gates, as the JAX script's: the two oracles within 1e-4 of each other, the
port within 1e-3 of the native solve; a failed gate exits with 1 after the
report is written.  The oracles' solves run in worker processes beside the
card's farm.

    python examples/torch_oracle_check.py [--cpu] [--n-instances 2]
        [--out-dir examples/output]

Writes ``torch_oracle_check.json``.  Small size for the CPU:
``--cpu --horizon 3 --nx 4 --lanes 4``.
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
ORACLES_TOL = 1e-4  # native vs ADMM root controls
ENGINE_TOL = 1e-3  # port (f32, tol 1e-3) vs native root controls
ITERS_PER_LAUNCH = 30  # farm iterations a CUDA-graph replay


def _spec(horizon, nx):
    from spock_tpu_torch.models import server_heat

    return server_heat.make_spec(N=horizon, nx=nx, d=2)


def native_solve(horizon, nx, x0):
    from spock_tpu_torch.baselines.native import NativeSolver

    t0 = time.perf_counter()
    out = NativeSolver(_spec(horizon, nx)).solve(
        np.asarray(x0, np.float64), tol=1e-6, max_iter=50000,
        algorithm="spock", warm_start=False)
    return dict(u0=out["u"][0].tolist(), objective=out["objective"],
                converged=bool(out["converged"]),
                iterations=int(out["iterations"]),
                wall_s=time.perf_counter() - t0)


def admm_solve(horizon, nx, x0):
    from spock_tpu_torch.baselines import admm_ref

    t0 = time.perf_counter()
    out = admm_ref.solve(_spec(horizon, nx), np.asarray(x0, np.float64),
                         tol=1e-8, max_iter=20000)
    return dict(u0=out["u"][0].tolist(), objective=float(out["objective"]),
                converged=bool(out["converged"]),
                iterations=int(out["iterations"]),
                wall_s=time.perf_counter() - t0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--n-instances", type=int, default=2)
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--horizon", type=int, default=10)
    ap.add_argument("--nx", type=int, default=20)
    ap.add_argument("--lanes", type=int, default=128,
                    help="the farm's lanes (the headline's B)")
    ap.add_argument("--workers", type=int, default=4,
                    help="processes for the oracles' solves")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args()

    from spock_tpu_torch import build, mpc
    from spock_tpu_torch.utils import runinfo

    device = runinfo.device(args.cpu)
    spec = _spec(args.horizon, args.nx)
    data, meta = build(spec, dtype=torch.float32, device=device)
    rng = np.random.default_rng(0)
    K = args.n_instances
    x0 = np.asarray(rng.uniform(-0.6, 0.6, (K, meta.nx)), np.float32)

    with concurrent.futures.ProcessPoolExecutor(
            max_workers=args.workers,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        jobs = [(pool.submit(native_solve, args.horizon, args.nx, x0[i]),
                 pool.submit(admm_solve, args.horizon, args.nx, x0[i]))
                for i in range(K)]

        # cold solves as a padded 1-step farm at the headline's shapes
        B = args.lanes
        x0_pad = np.zeros((B, meta.nx), np.float32)
        x0_pad[:K] = x0
        ws = torch.zeros((200, B), dtype=torch.int64)
        runinfo.reset_launches()
        t0 = time.perf_counter()
        res = mpc.simulate_async(
            data, meta, x0_pad, ws, args.tol, n_steps=1, device=device,
            iters_per_launch=ITERS_PER_LAUNCH, max_total_iters=25000)
        steps = res.steps_done.cpu()
        farm_s = time.perf_counter() - t0
        launches = runinfo.launches()
        if int(steps.min()) != 1:
            raise SystemExit("cold solve stalled")
        u_port = res.us[0, :K].double().cpu().numpy()
        obj_port = res.z.s[:K, 0].double().cpu().numpy()
        oracles = [(n.result(), a.result()) for n, a in jobs]

    rows = []
    for i, (nat, adm) in enumerate(oracles):
        u_nat, u_adm = np.asarray(nat["u0"]), np.asarray(adm["u0"])
        rows.append(dict(
            instance=i,
            port_converged=bool(steps[i] == 1),
            native_converged=nat["converged"],
            admm_converged=adm["converged"],
            u0_err_port_vs_native=float(np.max(np.abs(u_port[i] - u_nat))),
            u0_err_port_vs_admm=float(np.max(np.abs(u_port[i] - u_adm))),
            u0_err_native_vs_admm=float(np.max(np.abs(u_nat - u_adm))),
            obj=dict(port=float(obj_port[i]), native=nat["objective"],
                     admm=adm["objective"]),
            port_iterations=int(res.iters_per_step[0, i]),
            native=dict(iterations=nat["iterations"], wall_s=nat["wall_s"]),
            admm=dict(iterations=adm["iterations"], wall_s=adm["wall_s"])))
        print(json.dumps(rows[-1]), flush=True)

    worst_oracles = max(r["u0_err_native_vs_admm"] for r in rows)
    worst_engine = max(r["u0_err_port_vs_native"] for r in rows)
    summary = dict(
        summary="oracle agreement",
        config=dict(model=f"server_heat N={args.horizon} nx={args.nx} d=2",
                    tol=args.tol, lanes=B, dtype="float32",
                    iters_per_launch=ITERS_PER_LAUNCH),
        **runinfo.environment(device),
        paths=runinfo.path_flags(data, meta),
        farm=dict(wall_s=farm_s, farm_iterations=res.total_iterations,
                  run=res.run),
        launches=launches,
        worst_u0_err_native_vs_admm=worst_oracles,
        oracles_ok=bool(worst_oracles < ORACLES_TOL),
        worst_u0_err_engine_vs_native=worst_engine,
        engine_ok=bool(worst_engine < ENGINE_TOL),
    )
    summary["ok"] = bool(summary["oracles_ok"] and summary["engine_ok"])
    path = runinfo.write_json(args.out_dir, "torch_oracle_check.json",
                              dict(instances=rows, **summary))
    print(json.dumps(dict(summary, wrote=path)), flush=True)
    if not summary["ok"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
