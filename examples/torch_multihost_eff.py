"""Weak-scaling efficiency of lane sharding over processes on the port (the
counterpart of ``examples/multihost_eff.py``):

    efficiency = rate(2 processes) / (2 * rate(1 process))

at a fixed number of lanes per process (the JAX script's sizes: 32 lanes a
process, server_heat N=6 nx=8 d=2, float64, 6 timed warm-started SPOCK
``Solver`` solves after a cold one, tol 1e-4, x0 from ``default_rng(0)``).
Each process solves its block of the lanes (``parallel.mesh.shard_batch``)
with no collective inside a solve; after each solve one ``all_reduce``
takes the largest iteration count over the ranks, and the timed window
lies between two barriers.  ``--cpu``: gloo, one thread a process (the
CPU proxy of two hosts); otherwise NCCL with a card a process (two cards).

    python examples/torch_multihost_eff.py [--cpu] [--out-dir ...]

Writes ``torch_multihost_eff.json``.  Small size for the CPU: ``--cpu
--b-local 2 --solves 1 --horizon 3 --nx 3``.
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import tempfile
import time

import numpy as np
import torch

OUT_DIR = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "output")
N, NX, D = 6, 8, 2
TOL = 1e-4


def worker(argv):
    import torch.distributed as dist

    from spock_tpu_torch import build
    from spock_tpu_torch.models import server_heat
    from spock_tpu_torch.parallel import mesh as pmesh
    from spock_tpu_torch.parallel import spawn
    from spock_tpu_torch.solver import Solver

    rank, ranks, port, out_dir, a = spawn.worker_args(argv)
    device = torch.device(a["device"])
    mesh = spawn.join(rank, ranks, port, device)
    data, meta = build(server_heat.make_spec(N=a["horizon"], nx=a["nx"],
                                             d=D),
                       dtype=torch.float64, device=mesh.device)
    n_solves = a["solves"]
    B = a["b_local"] * ranks
    rng = np.random.default_rng(0)
    x0s = rng.uniform(-0.5, 0.5, (n_solves + 1, B, meta.nx))
    solver = Solver(pmesh.replicate(data, mesh), meta, algorithm="spock",
                    max_iter=3000, device=mesh.device)

    def solve(k, z, v):
        res = solver.solve(pmesh.shard_batch(x0s[k], mesh), z0=z, v0=v,
                           tol=TOL)
        top = res.iterations.max().to(torch.int64).reshape(1)
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=mesh.group)
        return res, int(top)

    res, _ = solve(0, None, None)  # cold, not timed
    dist.barrier(group=mesh.group)
    iters = 0
    t0 = time.perf_counter()
    for k in range(1, n_solves + 1):
        res, top = solve(k, res.z, res.v)
        iters += top
    dist.barrier(group=mesh.group)
    wall = time.perf_counter() - t0
    spawn.write(out_dir, rank, dict(
        nproc=ranks, B_global=B, solves=n_solves, wall_s=wall,
        rate_solves_per_s=B * n_solves / wall, sum_max_iters=iters,
        converged=bool(res.converged.all())))
    spawn.finish()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--b-local", type=int, default=32)
    ap.add_argument("--solves", type=int, default=6)
    ap.add_argument("--horizon", type=int, default=N)
    ap.add_argument("--nx", type=int, default=NX)
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args()

    from spock_tpu_torch.parallel import spawn
    from spock_tpu_torch.utils import runinfo

    device = runinfo.device(args.cpu)
    if device.type == "cuda" and torch.cuda.device_count() < 2:
        raise SystemExit("two processes on NCCL need two cards; --cpu runs "
                         "the gloo proxy")
    runs = {}
    for nproc in (1, 2):
        with tempfile.TemporaryDirectory() as tmp:
            runs[nproc] = spawn.Job(
                _os.path.abspath(__file__), nproc, tmp,
                dict(device=device.type, b_local=args.b_local,
                     solves=args.solves, horizon=args.horizon,
                     nx=args.nx)).wait()[0]
        print(json.dumps(runs[nproc]), flush=True)
    eff = runs[2]["rate_solves_per_s"] / (2.0 * runs[1]["rate_solves_per_s"])
    payload = dict(
        config=dict(model=f"server_heat N={args.horizon} nx={args.nx} d={D}",
                    tol=TOL,
                    dtype="float64", B_local=args.b_local,
                    solves=args.solves, threads_per_process=1,
                    proxy=("2 processes under gloo on one machine's CPU"
                           if device.type == "cpu" else
                           "2 processes under NCCL, a card each")),
        **runinfo.environment(device),
        one_process=runs[1], two_process=runs[2],
        weak_scaling_efficiency=eff)
    sizes = dict(b_local=args.b_local, solves=args.solves,
                 horizon=args.horizon, nx=args.nx)
    jax_sizes = dict(b_local=32, solves=6, horizon=N, nx=NX)
    if sizes != jax_sizes:
        payload["reduced"] = dict(sizes, jax_script=jax_sizes)
    path = runinfo.write_json(args.out_dir, "torch_multihost_eff.json",
                              payload)
    print(json.dumps({"wrote": path, "efficiency": eff}), flush=True)


if __name__ == "__main__":
    if len(_sys.argv) > 1 and _sys.argv[1] == "worker":
        worker(_sys.argv[2:])
    else:
        main()
