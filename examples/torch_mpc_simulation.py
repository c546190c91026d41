"""MPC closed loop on the port (the counterpart of
``examples/mpc_simulation.py`` and the reference's ``mpc_simulation.jl``:
nx = nu = 20, N = 10, d = 2, tol 1e-3, 20 steps, the M repeats as lanes).

Two legs on the same plants and realizations (``default_rng(0)``, the JAX
script's draws):

* ``simulate``: ``mpc.simulate``, every lane advancing in lockstep, one
  ``run_supermann`` a step (the fused step: one step launch and one
  backtrack launch a SuperMann iteration);
* ``async``: ``mpc.simulate_async``, the farm, each lane starting its next
  warm-started solve as its last converges, in CUDA-graph chunks of 30
  farm iterations.

Each leg's timed run follows ``--warmup-runs`` untimed ones (which build
and load the kernels and capture the graphs).  Reports per-step and
per-solve wall time, cold and warm iterations, and each leg's kernel
launches.

    python examples/torch_mpc_simulation.py [--cpu] [--repeats 15]
        [--steps 20] [--plot] [--trajectory] [--out-dir examples/output]

Writes ``torch_mpc_simulation.json``; ``--plot`` the PNG of iterations per
step (``--plot-only``: from the JSON already in ``--out-dir``, e.g. one
written on a machine without matplotlib), ``--trajectory`` the
``simulate`` leg's states and controls (``torch_mpc_simulation.npz``).
Small size for the CPU: ``--cpu --nx 3 --horizon 3 --repeats 4 --steps
3``.
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import time

import numpy as np
import torch

OUT_DIR = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "output")
ITERS_PER_LAUNCH = 30  # farm iterations a CUDA-graph replay


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def plot(payload, out_dir) -> str:
    """The PNG of iterations per step of each leg (min-max band, mean)."""
    from plotting import SERIES, new_axes

    from spock_tpu_torch.utils import runinfo

    cfg = payload["config"]
    fig, ax = new_axes(
        f"Warm-started MPC on the port (nx={cfg['nx']} N={cfg['horizon']}, "
        f"B={cfg['B']})", "MPC step", "SuperMann iterations per solve")
    for name, key in (("simulate", "spock"), ("async", "cp")):
        if name not in payload["legs"]:
            continue
        iters = np.asarray(payload["legs"][name]["iters_per_step"])
        steps_ax = np.arange(1, iters.shape[0] + 1)
        s = SERIES[key]
        ax.fill_between(steps_ax, iters.min(axis=1), iters.max(axis=1),
                        color=s["color"], alpha=0.18, lw=0)
        ax.plot(steps_ax, iters.mean(axis=1), color=s["color"], ls=s["ls"],
                lw=2, marker="o", ms=4,
                label="mpc.simulate" if name == "simulate"
                else "mpc.simulate_async")
    ax.set_ylim(bottom=0)
    ax.legend(fontsize=9, frameon=False)
    return runinfo.save_figure(fig, out_dir, "torch_mpc_simulation.png")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--repeats", type=int, default=15)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--nx", type=int, default=20)
    ap.add_argument("--horizon", type=int, default=10)
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--plot-only", action="store_true",
                    help="draw the PNG from the JSON in --out-dir, run "
                    "nothing")
    ap.add_argument("--trajectory", action="store_true")
    ap.add_argument("--legs", default="simulate,async")
    ap.add_argument("--warmup-runs", type=int, default=1,
                    help="untimed runs of a leg before its timed run")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args()
    if args.plot_only:
        with open(_os.path.join(args.out_dir,
                                "torch_mpc_simulation.json")) as f:
            print(json.dumps({"png": plot(json.load(f), args.out_dir)}))
        return

    from spock_tpu_torch import build, mpc
    from spock_tpu_torch.models import server_heat
    from spock_tpu_torch.utils import runinfo

    device = runinfo.device(args.cpu)
    dtype = torch.float64 if args.f64 else torch.float32
    spec = server_heat.make_spec(N=args.horizon, nx=args.nx, d=2)
    data, meta = build(spec, dtype=dtype, device=device)

    rng = np.random.default_rng(0)
    B = args.repeats
    x0 = torch.as_tensor(rng.uniform(-0.1, 0.1, (B, meta.nx)), dtype=dtype)
    ws = torch.as_tensor(rng.integers(0, 2, (args.steps, B)))

    legs = {
        "simulate": lambda: mpc.simulate(data, meta, x0, ws, tol=args.tol,
                                         device=device),
        "async": lambda: mpc.simulate_async(
            data, meta, x0, ws, args.tol, n_steps=args.steps, device=device,
            iters_per_launch=ITERS_PER_LAUNCH),
    }
    out, results = {}, {}
    for name in args.legs.split(","):
        run_once = legs[name]
        t0 = time.perf_counter()
        for _ in range(args.warmup_runs):
            run_once()
        _sync(device)
        first = time.perf_counter() - t0
        runinfo.reset_launches()
        t0 = time.perf_counter()
        res = run_once()
        _sync(device)
        run = time.perf_counter() - t0
        launches = runinfo.launches()
        if name == "async":
            iters = res.iters_per_step.cpu().numpy()
            unconverged = int((res.steps_done != args.steps).sum())
            extra = dict(farm_iterations=res.total_iterations, run=res.run)
        else:
            iters = res.iterations.cpu().numpy()
            unconverged = int((res.status != 0).sum())
            extra = {}
        results[name] = (res, iters)
        out[name] = dict(
            total_wall_s=run,
            per_step_wall_ms=1e3 * run / args.steps,
            per_solve_wall_ms=1e3 * run / (args.steps * B),
            mean_iters_cold_step=float(iters[0].mean()),
            mean_iters_warm_steps=float(iters[1:].mean()),
            unconverged=unconverged,
            warmup_s=first,
            launches=launches, iters_per_step=iters.tolist(), **extra)
        print(json.dumps({name: out[name]}), flush=True)

    payload = dict(
        config=dict({k: v for k, v in vars(args).items() if k != "out_dir"},
                    B=B, d=2, dtype=str(dtype)),
        **runinfo.environment(device),
        paths=runinfo.path_flags(data, meta), legs=out)
    if args.trajectory and "simulate" in results:
        res = results["simulate"][0]
        path = runinfo.output_path(args.out_dir, "torch_mpc_simulation.npz")
        np.savez(path, xs=res.xs.double().cpu().numpy(),
                 us=res.us.double().cpu().numpy(),
                 iterations=res.iterations.cpu().numpy())
        payload["trajectory"] = _os.path.basename(path)
    if args.plot:
        payload["png"] = _os.path.basename(plot(payload, args.out_dir))
    path = runinfo.write_json(args.out_dir, "torch_mpc_simulation.json",
                              payload)
    print(json.dumps({"wrote": path}), flush=True)


if __name__ == "__main__":
    main()
