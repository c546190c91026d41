"""Residual against work on the port (the counterpart of
``examples/residuals.py`` and the reference's ``residuals.jl``: nx = 5,
N = 7, d = 2, tol 1e-5, float64): the CP and SPOCK residual traces from
record mode, with SuperMann's backtracking trials counted as extra operator
applications, as the JAX script counts them.

CP runs ``run_cp`` (one cp_sweep_fused launch an iteration on the card);
SPOCK runs ``run_supermann`` (the fused step: one step and one backtrack
launch an iteration).  x0 from ``default_rng(0)`` as in the JAX script.

    python examples/torch_residuals.py [--cpu] [--plot]
        [--out-dir examples/output]

Writes ``torch_residuals_cp.csv`` and ``torch_residuals_spock.csv``
(op_calls, xi1, xi2[, backtracks]), ``torch_residuals.json`` and, with
``--plot``, ``torch_residuals.png`` (``--plot-only``: from the CSVs
already in ``--out-dir``, e.g. written on a machine without matplotlib).
Small size for the CPU: ``--cpu --nx 3 --horizon 4``.
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


def plot(out_dir, nx, horizon, tol) -> str:
    """The PNG of residual against operator calls, from the CSVs."""
    from plotting import SERIES, new_axes

    from spock_tpu_torch.utils import runinfo

    fig, ax = new_axes(
        f"Residual vs operator calls, port (nx={nx} N={horizon}, "
        f"tol={tol:g})", "operator (L / L') applications",
        "termination residual  max(ξ₁, ξ₂)")
    for key in ("cp", "spock"):
        trace = np.loadtxt(
            _os.path.join(out_dir, f"torch_residuals_{key}.csv"),
            delimiter=",", ndmin=2)
        s = SERIES[key]
        ax.semilogy(trace[:, 0], trace[:, 1:3].max(axis=1), color=s["color"],
                    ls=s["ls"], lw=2, label=s["label"])
    ax.axhline(tol, color="0.6", lw=1, ls=":")
    ax.legend(fontsize=9, frameon=False)
    return runinfo.save_figure(fig, out_dir, "torch_residuals.png")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--nx", type=int, default=5)
    ap.add_argument("--horizon", type=int, default=7)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--plot-only", action="store_true",
                    help="draw the PNG from the CSVs in --out-dir, run "
                    "nothing")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args()
    if args.plot_only:
        print(json.dumps({"png": plot(args.out_dir, args.nx, args.horizon,
                                      args.tol)}))
        return

    from spock_tpu_torch import build
    from spock_tpu_torch.algorithms import cp as cp_alg
    from spock_tpu_torch.algorithms import supermann as sp_alg
    from spock_tpu_torch.models import server_heat
    from spock_tpu_torch.solver import zero_dual, zero_primal
    from spock_tpu_torch.utils import runinfo

    device = runinfo.device(args.cpu)
    dtype = torch.float64
    spec = server_heat.make_spec(N=args.horizon, nx=args.nx, d=2)
    data, meta = build(spec, dtype=dtype, device=device)
    rng = np.random.default_rng(0)
    x0 = torch.as_tensor(rng.uniform(-0.1, 0.1, (1, meta.nx)), dtype=dtype,
                         device=device)
    z0 = zero_primal(meta, (1,), dtype, device)
    v0 = zero_dual(meta, (1,), dtype, device)

    runinfo.reset_launches()
    res_cp = cp_alg.run_cp(data, meta, x0, z0, v0, tol=args.tol,
                           max_iter=5000, record=True)
    cp_launches = runinfo.launches()
    runinfo.reset_launches()
    res_sp = sp_alg.run_supermann(data, meta, x0, z0, v0, tol=args.tol,
                                  max_iter=1000, record=True)
    sp_launches = runinfo.launches()

    n_cp = int(res_cp.iterations[0])
    n_sp = int(res_sp.iterations[0])
    cp_trace = res_cp.residuals[:n_cp, 0, :].cpu().numpy()  # xi1, xi2
    sp_trace = res_sp.residuals[:n_sp, 0, :].cpu().numpy()  # xi1, xi2, bt

    # operator-call accounting of the JAX script: CP ~4 L-applications an
    # iteration; SPOCK ~12, and 4 more per backtracking trial
    cp_calls = 4 * np.arange(1, n_cp + 1)
    sp_calls = np.cumsum(12 + 4 * np.maximum(sp_trace[:, 2], 0))
    paths = {}
    for name, calls, trace, header in (
            ("cp", cp_calls, cp_trace, "op_calls,xi1,xi2"),
            ("spock", sp_calls, sp_trace, "op_calls,xi1,xi2,backtracks")):
        paths[name] = f"torch_residuals_{name}.csv"
        np.savetxt(runinfo.output_path(args.out_dir, paths[name]),
                   np.column_stack([calls, trace]), header=header,
                   delimiter=",")
    png = _os.path.basename(plot(args.out_dir, args.nx, args.horizon,
                                 args.tol)) if args.plot else None
    out = dict(
        config=dict(model=f"server_heat N={args.horizon} nx={args.nx} d=2",
                    tol=args.tol, dtype="float64"),
        **runinfo.environment(device),
        paths=runinfo.path_flags(data, meta),
        cp_iters=n_cp, spock_iters=n_sp,
        cp_final_xi=[float(res_cp.xi1[0]), float(res_cp.xi2[0])],
        spock_final_xi=[float(res_sp.xi1[0]), float(res_sp.xi2[0])],
        cp_converged=bool(res_cp.converged[0]),
        spock_converged=bool(res_sp.converged[0]),
        launches=dict(cp=cp_launches, spock=sp_launches),
        csv=paths, png=png)
    path = runinfo.write_json(args.out_dir, "torch_residuals.json", out)
    print(json.dumps(dict(out, wrote=path), indent=1), flush=True)


if __name__ == "__main__":
    main()
