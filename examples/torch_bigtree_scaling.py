"""Node-sharded big-tree solves on the port: the wall of an iteration
against the rank count (the counterpart of ``examples/bigtree_scaling.py``).

server_heat d = 3, nx = nu = 4, N = ``--horizon`` (10: 29,524 nodes) with
BASELINE config 4's band -2 <= 1'x <= 2 at every node, x0 = (0.3, -0.2,
0.1, 0.05), float32, one lane; ``parallel.bigtree.run_cp_sharded`` and
``run_sp_sharded`` for a fixed budget of ``--iters`` iterations (tol 0) on
P ranks, one process each (``parallel.spawn``): gloo on the CPU with
``--cpu`` (P = 1, 2, 4, a thread each: a CPU proxy), NCCL with a card a
process otherwise (P up to the machine's cards; those above are listed in
``reduced``).  Each run is made twice, the second timed.  Per row: ms per
iteration, the final residuals, and ``stats=``: collectives and their bytes
per iteration, by kind, against the bytes of the whole iterate.

    python examples/torch_bigtree_scaling.py [--cpu] [--horizon 10]
        [--iters 30] [--ranks 1,2,4] [--out-dir examples/output]

Writes ``torch_bigtree_scaling_gloo.json`` (``--cpu``) or
``torch_bigtree_scaling_nccl.json``.  Small size for the CPU: ``--cpu
--horizon 5 --iters 10 --ranks 1,2``.
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import dataclasses
import json
import tempfile
import time

import numpy as np
import torch

OUT_DIR = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "output")
NX, D = 4, 3
X0 = [[0.3, -0.2, 0.1, 0.05]]


def _spec(N):
    from spock_tpu_torch import problem
    from spock_tpu_torch.models import server_heat

    Gx = np.ones((1, NX))
    return dataclasses.replace(
        server_heat.make_spec(N=N, nx=NX, d=D),
        polytope=problem.Polytope(
            Gx=Gx, Gu=np.zeros((1, NX)), lo=np.array([-2.0]),
            hi=np.array([2.0]), GxN=Gx, loN=np.array([-2.0]),
            hiN=np.array([2.0])))


def worker(argv):
    """One rank: each algorithm run twice on the rank's share, the second
    timed between barriers."""
    import torch.distributed as dist

    from spock_tpu_torch import build
    from spock_tpu_torch.parallel import bigtree, spawn
    from spock_tpu_torch.utils import runinfo

    rank, ranks, port, out_dir, a = spawn.worker_args(argv)
    device = torch.device(a["device"])
    mesh = spawn.join(rank, ranks, port, device, axis="node")
    data, meta = build(_spec(a["horizon"]), dtype=torch.float32,
                       device=mesh.device)
    rows = []
    for algo, run in (("cp", bigtree.run_cp_sharded),
                      ("spock", bigtree.run_sp_sharded)):
        stats = {}

        def once(st):
            res, _ = run(data, meta, X0, tol=0.0, max_iter=a["iters"],
                         mesh=mesh, stats=st)
            return res

        once(None)
        runinfo.reset_launches()
        dist.barrier(group=mesh.group)
        t0 = time.perf_counter()
        res = once(stats)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        wall = time.perf_counter() - t0
        rows.append(dict(
            ranks=ranks, algo=algo, iters=int(res.iterations.max()),
            wall_s=wall, ms_per_iter=1e3 * wall / a["iters"],
            xi1=float(res.xi1[0]), xi2=float(res.xi2[0]),
            collectives_per_iter=stats["count"],
            collective_bytes_per_iter=stats["bytes"],
            collectives_by_kind=stats["by_kind"], stage=stats["stage"],
            iterate_bytes=stats["iterate_bytes"],
            rank_iterate_bytes=stats["rank_iterate_bytes"],
            collective_frac_of_iterate=stats["collective_frac_of_iterate"],
            launches={k: c for k, c in runinfo.launches().items() if c}))
    spawn.write(out_dir, rank, dict(rows=rows, n=meta.tree.n))
    spawn.finish()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--horizon", type=int, default=10)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--ranks", default="1,2,4")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args()

    from spock_tpu_torch.parallel import spawn
    from spock_tpu_torch.utils import runinfo

    device = runinfo.device(args.cpu)
    backend = "gloo" if device.type == "cpu" else "nccl"
    rows, skipped, n = [], [], None
    for P in (int(p) for p in args.ranks.split(",")):
        if device.type == "cuda" and P > torch.cuda.device_count():
            skipped.append(P)
            continue
        with tempfile.TemporaryDirectory() as tmp:
            out = spawn.Job(_os.path.abspath(__file__), P, tmp,
                            dict(device=device.type, horizon=args.horizon,
                                 iters=args.iters)).wait()
        n = out[0]["n"]
        for i, row in enumerate(out[0]["rows"]):
            row["wall_s"] = max(o["rows"][i]["wall_s"] for o in out)
            row["ms_per_iter"] = 1e3 * row["wall_s"] / args.iters
            rows.append(row)
            print(json.dumps({k: row[k] for k in (
                "ranks", "algo", "ms_per_iter", "xi1", "xi2",
                "collectives_per_iter", "collective_bytes_per_iter")}),
                flush=True)
    payload = dict(
        config=dict(N=args.horizon, d=D, nx=NX, n=n, iters=args.iters,
                    dtype="float32", backend=backend,
                    polytope="-2 <= 1'x <= 2 at every node",
                    threads_per_rank=1),
        **runinfo.environment(device), rows=rows)
    if skipped:
        payload["reduced"] = dict(ranks_not_run=skipped,
                                  why=f"{torch.cuda.device_count()} card(s)")
    path = runinfo.write_json(args.out_dir,
                              f"torch_bigtree_scaling_{backend}.json",
                              payload)
    print(json.dumps({"wrote": path}), flush=True)


if __name__ == "__main__":
    if len(_sys.argv) > 1 and _sys.argv[1] == "worker":
        worker(_sys.argv[2:])
    else:
        main()
