"""Worker processes of the port's multi-process tests (gloo on the CPU).

    python tests/torch_dist_worker.py MODE RANK RANKS PORT OUT_DIR [ARG]

Each of RANKS processes joins one job on 127.0.0.1:PORT
(``parallel.mesh.init_distributed`` with ``device="cpu"``), runs ``mode``
and writes ``OUT_DIR/RANK.npz``.  :class:`Job` starts the processes
from a test (which may work meanwhile) and waits for them with a time
limit; :func:`launch` does both.  This module imports neither JAX nor
the JAX package.

Modes:
  lanes      the lane-sharded Solver (server_heat N=3 nx=3 d=2, B=8, f64,
             tol 1e-6) and lane-sharded ``mpc.simulate_async`` (N=4 nx=4,
             B=2 P, 3 steps, tol 1e-4), gathered on every rank;
  cp <d>     ``bigtree.run_cp_sharded`` on server_heat N=6 nx=4, B=2, f64,
             600 iterations at tol 1e-6, with its stats;
  sp         ``bigtree.run_sp_sharded`` on server_heat N=5 nx=4 d=3, B=2,
             f64, tol 1e-4, and one iteration from a carry 3 iterations in
             against the unsharded composed ``sp_body``;
  polytope   ``run_sp_sharded`` on N=8 d=3 nx=4 with the band
             -2 <= 1'x <= 2 at every node (BASELINE config 4's constraint),
             tol 1e-3.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Job:
    """``ranks`` worker processes running one mode; :meth:`wait` returns
    their npz contents by rank.  A process that fails or outlives
    TIMEOUT_S fails the caller, and no process outlives the wait."""

    def __init__(self, mode: str, ranks: int, out_dir, *args):
        port = free_port()
        env = {k: v for k, v in os.environ.items()
               if k not in ("PYTHONPATH", "JAX_PLATFORMS", "XLA_FLAGS")}
        env.update(PYTHONPATH=str(REPO), GLOO_SOCKET_IFNAME="lo",
                   OMP_NUM_THREADS="1")
        self.out_dir, self.ranks = Path(out_dir), ranks
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, mode, str(r), str(ranks), str(port),
             str(out_dir), *map(str, args)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(ranks)]

    def wait(self) -> list:
        outs = []
        try:
            for p in self.procs:
                outs.append(p.communicate(timeout=TIMEOUT_S)[0].decode())
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, o in zip(self.procs, outs):
            assert p.returncode == 0, o[-3000:]
        return [dict(np.load(self.out_dir / f"{r}.npz"))
                for r in range(self.ranks)]


def launch(mode: str, ranks: int, out_dir, *args) -> list:
    """Runs ``mode`` in ``ranks`` processes and waits for them."""
    return Job(mode, ranks, out_dir, *args).wait()


def _np(t):
    return t.detach().cpu().numpy()


def _server_heat(N, nx, d, polytope=False):
    import dataclasses

    import torch

    from spock_tpu_torch import build, problem
    from spock_tpu_torch.models import server_heat

    spec = server_heat.make_spec(N=N, nx=nx, d=d)
    if polytope:
        Gx = np.ones((1, nx))
        spec = dataclasses.replace(spec, polytope=problem.Polytope(
            Gx=Gx, Gu=np.zeros((1, nx)), lo=np.array([-2.0]),
            hi=np.array([2.0]), GxN=Gx, loN=np.array([-2.0]),
            hiN=np.array([2.0])))
    return build(spec, dtype=torch.float64, device="cpu")


def run_lanes(mesh):
    import torch

    from spock_tpu_torch import mpc
    from spock_tpu_torch.parallel import mesh as pmesh
    from spock_tpu_torch.solver import Solver

    data, meta = _server_heat(3, 3, 2)
    x0 = np.random.default_rng(0).uniform(-0.5, 0.5, (8, meta.nx))
    res = Solver(pmesh.replicate(data, mesh), meta, device="cpu").solve(
        pmesh.shard_batch(x0, mesh), tol=1e-6)
    u, s0, status = pmesh.gather_batch(
        (res.z.u, res.z.s[:, 0], res.status), mesh)

    data, meta = _server_heat(4, 4, 2)
    B, T = 2 * mesh.size, 3
    rng = np.random.default_rng(5)
    x0 = rng.uniform(-0.5, 0.5, (B, meta.nx))
    ws = rng.integers(0, meta.tree.d, (T, B))
    far = mpc.simulate_async(
        pmesh.replicate(data, mesh), meta, pmesh.shard_batch(x0, mesh),
        torch.as_tensor(ws[:, mesh.rank * 2:(mesh.rank + 1) * 2]), tol=1e-4,
        n_steps=T, device="cpu")
    us, steps = pmesh.gather_batch((far.us.transpose(0, 1), far.steps_done),
                                   mesh)
    return dict(u=_np(u), s0=_np(s0), status=_np(status),
                us=_np(us.transpose(0, 1)), steps_done=_np(steps))


def run_cp(mesh, d):
    from spock_tpu_torch.parallel import bigtree

    data, meta = _server_heat(6, 4, int(d))
    x0 = np.random.default_rng(3).uniform(-0.5, 0.5, (2, meta.nx))
    stats = {}
    res, (zl, vl) = bigtree.run_cp_sharded(data, meta, x0, tol=1e-6,
                                           max_iter=600, mesh=mesh,
                                           stats=stats)
    return dict(iterations=_np(res.iterations), u=_np(res.z.u),
                s0=_np(res.z.s[:, 0]), stage=stats["stage"],
                rank_bytes=stats["rank_iterate_bytes"],
                whole_bytes=stats["iterate_bytes"],
                top_bytes=stats["top_bytes"],
                gathers=stats["by_kind"]["all_gather"]["count"],
                reduces=stats["by_kind"]["all_reduce"]["count"])


def _carry_err(a, b) -> float:
    import dataclasses

    import torch

    from spock_tpu_torch.zv import leaves

    worst = 0.0
    for f in dataclasses.fields(a):
        for x, y in zip(leaves(getattr(a, f.name)),
                        leaves(getattr(b, f.name))):
            if torch.is_tensor(x) and x.is_floating_point():
                same = x == y  # infinities (r_safe) equal
                worst = max(worst, float(torch.where(
                    same, 0.0, (x - y).abs()).max()))
    return worst


def run_sp(mesh):
    import dataclasses

    import torch

    from spock_tpu_torch.algorithms import supermann as sp
    from spock_tpu_torch.parallel import bigtree
    from spock_tpu_torch.solver import zero_dual, zero_primal

    data, meta = _server_heat(5, 4, 3)
    x0 = np.random.default_rng(4).uniform(-0.5, 0.5, (2, meta.nx))
    res, _ = bigtree.run_sp_sharded(data, meta, x0, tol=1e-4, max_iter=1000,
                                    mesh=mesh)
    # one iteration from the same carry, 3 iterations into a cold solve
    opts = sp.SuperMannOpts()
    xt = torch.as_tensor(x0)
    c = sp.sp_init(meta, xt, zero_primal(meta, (2,), torch.float64, "cpu"),
                   zero_dual(meta, (2,), torch.float64, "cpu"), opts)
    body = sp.sp_body(data, meta, 1e-4, opts, fused_sweep=False)
    for _ in range(3):
        c = body(c)
    ref = body(c)
    sh = bigtree.Sharded(data, meta, mesh)
    node = ("z", "v", "r_prev", "s_prev", "dirstate", "zbar_c", "vbar_c")
    local = dataclasses.replace(c, **{f: sh.share(getattr(c, f))
                                      for f in node})
    got = sp.sp_body(sh.data, sh.meta, 1e-4, opts, fused_sweep=False,
                     ops=sh.ops)(local)
    got = dataclasses.replace(got, **{f: sh.whole(getattr(got, f))
                                      for f in node})
    return dict(status=_np(res.status), iterations=_np(res.iterations),
                u_root=_np(res.z.u[:, :, 0]), s1=_np(res.z.s[:, 0]),
                one_iteration_err=_carry_err(got, ref))


def run_polytope(mesh):
    from spock_tpu_torch.parallel import bigtree

    data, meta = _server_heat(8, 4, 3, polytope=True)
    x0 = np.array([[0.3, -0.2, 0.1, 0.05]])
    res, _ = bigtree.run_sp_sharded(data, meta, x0, tol=1e-3, max_iter=400,
                                    mesh=mesh)
    return dict(status=_np(res.status), iterations=_np(res.iterations),
                g=_np(res.z.x[0].sum(0)))


def main():
    mode, rank, ranks, port, out_dir = sys.argv[1:6]
    args = sys.argv[6:]
    import torch

    torch.set_num_threads(1)
    from spock_tpu_torch.parallel import mesh as pmesh

    pmesh.init_distributed(f"127.0.0.1:{port}", int(ranks), int(rank),
                           device="cpu")
    mesh = pmesh.make_mesh(device="cpu")
    assert mesh.size == int(ranks) and mesh.rank == int(rank)
    run = dict(lanes=run_lanes, cp=run_cp, sp=run_sp,
               polytope=run_polytope)[mode]
    out = run(mesh, *args)
    np.savez(Path(out_dir) / f"{rank}.npz", **out)
    # Every rank past its last collective, then out without tearing the
    # group down: in gloo's teardown a rank whose peers have already gone
    # can abort ("terminate called without an active exception", seen in
    # a 3-process run), failing a job whose work was done.
    torch.distributed.barrier()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    main()
