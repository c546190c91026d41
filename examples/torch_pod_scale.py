"""Pod-scale batch on the port (BASELINE config 5; the counterpart of
``examples/pod_scale.py``): lane scaling on one card, and the cost of lane
sharding at fixed work over processes.

``--leg chip`` (default): the headline farm (server_heat N=10, nx=nu=20,
d=2, tol 1e-3, float32) on the main path, the fused step in CUDA-graph
chunks of 30 farm iterations, at B = 128 .. 8,192 lanes:
``--warm-steps`` (8) steps from cold, then a timed window of ``--steps``
warm-started steps chained from them (on the graphs the warm-up
captured).  Per B:
solves/s, ms per farm iteration, the step kernels' launches, and the
bytes a lane takes, reckoned (the fused carry ``SPCarryF``'s tensors: ten
(z, v) pairs and the per-lane scalars) and measured (the peak of
``torch.cuda.max_memory_allocated()`` over the farm, above what was held
before it, divided by B).  A ``torch.cuda.OutOfMemoryError`` is the memory
wall: it is recorded as a row (B and the allocation the card refused) and
ends the sweep; any other error raises.

``--leg mesh``: the lane-sharding overhead at fixed total lanes (server_heat
N=6 nx=8 d=2, 128 lanes, 12 timed steps after 8), the farm over P = 1, 2,
4 processes through ``parallel.mesh`` (``shard_batch``, ``replicate``):
gloo on the CPU with ``--cpu``, where the P processes share THREADS
threads (so the work's CPU stays fixed and rate(P)/rate(1) reads the
overhead), or NCCL with a card a process (P above the machine's cards is
not run and is listed in ``reduced``).

    python examples/torch_pod_scale.py [--cpu] [--leg chip|mesh]
        [--bs 128,256,...] [--steps 100] [--out-dir examples/output]

Writes ``torch_pod_scale.json`` (chip leg) or ``torch_pod_scale_mesh.json``.
Small size for the CPU: ``--cpu --horizon 3 --nx 3 --bs 4,8 --steps 2
--warm-steps 1`` (chip leg), ``--cpu --leg mesh --horizon 3 --nx 3 --lanes
8 --steps 2 --warm-steps 1 --ranks 1,2`` (mesh leg).
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import re
import tempfile
import time

import numpy as np
import torch

OUT_DIR = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "output")
BS = "128,256,512,1024,2048,4096,8192"
THREADS = 4  # the mesh leg's threads on the CPU, shared by its processes
CHUNK = 30  # farm iterations a CUDA-graph replay (chip_smoke.py's)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def farm_rate(data, meta, x0, ws, warm, steps, tol, chunk, device):
    """``warm`` steps from cold, then ``steps`` warm-started steps timed;
    returns (the timed result, its wall seconds, the warm-up result)."""
    from spock_tpu_torch import mpc

    r1 = mpc.simulate_async(data, meta, x0, ws, tol, n_steps=warm,
                            iters_per_launch=chunk, device=device)
    _sync(device)
    t0 = time.perf_counter()
    r2 = mpc.simulate_async(data, meta, r1.xs, ws, tol, n_steps=steps,
                            z0=r1.z, v0=r1.v, iters_per_launch=chunk,
                            device=device)
    _sync(device)
    return r2, time.perf_counter() - t0, r1


def carry_bytes(state, B: int) -> float:
    """Bytes of the farm's carry a lane: every tensor of ``SPCarryF``."""
    from spock_tpu_torch.zv import leaves

    return sum(a.numel() * a.element_size() for a in leaves(state["sp"])
               if torch.is_tensor(a)) / B


def chip_leg(args, device):
    from spock_tpu_torch import build, mpc
    from spock_tpu_torch.models import server_heat
    from spock_tpu_torch.ops import _build
    from spock_tpu_torch.utils import runinfo

    if device.type == "cuda":
        _build.build_all(["sp_step"])
    spec = server_heat.make_spec(N=args.horizon, nx=args.nx, d=2)
    data, meta = build(spec, dtype=torch.float32, device=device)
    rows = []
    for B in (int(b) for b in args.bs.split(",")):
        rng = np.random.default_rng(0)
        x0 = torch.as_tensor(rng.uniform(-0.6, 0.6, (B, meta.nx)),
                             dtype=torch.float32)
        ws = torch.as_tensor(rng.integers(0, 2, (max(args.steps,
                                                     args.warm_steps), B)))
        mpc.clear_graphs()
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
            held = torch.cuda.memory_allocated(device)
        runinfo.reset_launches()
        try:
            r2, dt, r1 = farm_rate(data, meta, x0, ws, args.warm_steps,
                                   args.steps, args.tol, CHUNK, device)
        except torch.cuda.OutOfMemoryError as exc:
            asked = re.search(r"Tried to allocate ([\d.]+ [KMGT]iB)",
                              str(exc))
            rows.append(dict(B=B, error="out of memory",
                             allocation_refused=asked and asked.group(1),
                             message=str(exc)[:600]))
            print(json.dumps(rows[-1]), flush=True)
            break
        launches = runinfo.launches()
        solves = int(r2.steps_done.sum())
        row = dict(
            B=B, solves_per_s=solves / dt, wall_s=dt, solves=solves,
            farm_iterations=r2.total_iterations,
            ms_per_farm_iteration=1e3 * dt / r2.total_iterations,
            mean_iters_per_solve=float(
                r2.iters_per_step[:args.steps].double().mean()),
            warmup_farm_iterations=r1.total_iterations,
            run=r2.run, captures=r1.run["captures"] + r2.run["captures"],
            launches={k: c for k, c in launches.items() if c},
            carry_bytes_per_lane=carry_bytes(r2.state, B))
        if device.type == "cuda":
            peak = torch.cuda.max_memory_allocated(device)
            row.update(peak_bytes=peak, held_before_bytes=held,
                       measured_bytes_per_lane=(peak - held) / B)
        rows.append(row)
        print(json.dumps(row), flush=True)
        del r1, r2
    mpc.clear_graphs()
    return dict(
        leg="chip", config=f"server_heat nx={args.nx} N={args.horizon} d=2",
        protocol=(f"{args.warm_steps} warm-up steps from cold, then "
                  f"{args.steps} warm-started steps timed; iters_per_launch="
                  f"{CHUNK}, tol={args.tol}, float32, the fused step"),
        paths=runinfo.path_flags(data, meta), rows=rows)


def mesh_worker(argv):
    """One rank of the mesh leg: its shard of the lanes' farm, started
    after a barrier; the leg's wall is the slowest rank's."""
    import torch.distributed as dist

    from spock_tpu_torch import build
    from spock_tpu_torch.models import server_heat
    from spock_tpu_torch.parallel import mesh as pmesh
    from spock_tpu_torch.parallel import spawn

    rank, ranks, port, out_dir, a = spawn.worker_args(argv)
    device = torch.device(a["device"])
    mesh = spawn.join(rank, ranks, port, device)
    spec = server_heat.make_spec(N=a["horizon"], nx=a["nx"], d=2)
    data, meta = build(spec, dtype=torch.float32, device=mesh.device)
    B, steps = a["lanes"], a["steps"]
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-0.6, 0.6, (B, meta.nx)).astype(np.float32)
    ws = rng.integers(0, 2, (max(steps, a["warm_steps"]), B))
    per = B // mesh.size
    lanes = slice(mesh.rank * per, (mesh.rank + 1) * per)
    data_l = pmesh.replicate(data, mesh)
    x0_l = pmesh.shard_batch(x0, mesh)
    ws_l = torch.as_tensor(ws[:, lanes])
    dist.barrier()
    r2, dt, _ = farm_rate(data_l, meta, x0_l, ws_l, a["warm_steps"], steps,
                          a["tol"], CHUNK, mesh.device)
    solves = torch.tensor([int(r2.steps_done.sum())], device=mesh.device)
    dist.all_reduce(solves, group=mesh.group)
    spawn.write(out_dir, rank, dict(rank=rank, wall_s=dt,
                                    solves=int(solves)))
    spawn.finish()


def mesh_leg(args, device):
    from spock_tpu_torch.parallel import spawn

    rows, skipped, base = [], [], None
    for P in (int(p) for p in args.ranks.split(",")):
        if device.type == "cuda" and P > torch.cuda.device_count():
            skipped.append(P)
            continue
        threads = max(1, THREADS // P)
        with tempfile.TemporaryDirectory() as tmp:
            out = spawn.Job(_os.path.abspath(__file__), P, tmp,
                            dict(device=device.type, horizon=args.horizon,
                                 nx=args.nx, lanes=args.lanes,
                                 steps=args.steps,
                                 warm_steps=args.warm_steps, tol=args.tol),
                            threads=threads).wait()
        wall = max(r["wall_s"] for r in out)
        rate = out[0]["solves"] / wall
        base = base or rate
        rows.append(dict(ranks=P, B=args.lanes, threads_per_rank=threads,
                         solves=out[0]["solves"], wall_s=wall,
                         solves_per_s=rate, rate_vs_1rank=rate / base))
        print(json.dumps(rows[-1]), flush=True)
    out = dict(
        leg="mesh", config=f"server_heat nx={args.nx} N={args.horizon} d=2",
        total_lanes=args.lanes,
        backend="gloo" if device.type == "cpu" else "nccl",
        measures=("lane-sharding overhead at fixed work: the processes "
                  "share the same CPU threads (gloo) or have a card each "
                  "(nccl); rate_vs_1rank ~ 1 means the sharding is cheap"),
        rows=rows)
    if skipped:
        out["reduced"] = dict(ranks_not_run=skipped,
                              why=f"{torch.cuda.device_count()} card(s)")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--leg", choices=("chip", "mesh"), default="chip")
    ap.add_argument("--horizon", type=int, default=None)
    ap.add_argument("--nx", type=int, default=None)
    ap.add_argument("--bs", default=BS)
    ap.add_argument("--lanes", type=int, default=128)
    ap.add_argument("--ranks", default="1,2,4")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--warm-steps", type=int, default=8,
                    help="steps from cold before the timed window")
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args()
    chip = args.leg == "chip"
    # the JAX script's sizes of each leg
    args.horizon = args.horizon or (10 if chip else 6)
    args.nx = args.nx or (20 if chip else 8)
    args.steps = args.steps or (100 if chip else 12)

    from spock_tpu_torch.utils import runinfo

    device = runinfo.device(args.cpu)
    out = chip_leg(args, device) if chip else mesh_leg(args, device)
    out.update(runinfo.environment(device))
    if chip and args.bs != BS:
        out.setdefault("reduced", dict(bs=args.bs, jax_script_port=BS))
    name = "torch_pod_scale.json" if chip else "torch_pod_scale_mesh.json"
    path = runinfo.write_json(args.out_dir, name, out)
    print(json.dumps({"wrote": path}), flush=True)


if __name__ == "__main__":
    if len(_sys.argv) > 1 and _sys.argv[1] == "worker":
        mesh_worker(_sys.argv[2:])
    else:
        main()
