"""Cold solves back to back through ``Solver.solve``, each from zero (z, v):
the time to a solution at the configuration's tolerance.

Mix parameters: ``x0_half_width`` (every solve's state is a fresh draw
from U(-h, h), made from ``--seed``), ``max_solves`` (the draws made, a
bound above the window's solves), ``warmup_solves``, ``check_samples``
(solves compared with the reference, the solve of the most iterations
among them; every solve's trajectory is checked).

The window solves until ``--seconds`` have passed and finishes the solve
in flight: no solve is cut.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from . import _common


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def setup(run, log):
    from spock_tpu_torch import Solver

    cfg, mix, dev = run["config"], run["mix"], run["device"]
    data, meta = _common.build(run, log)
    solver = Solver(data, meta, algorithm="spock", device=dev)
    g = _common.generator(run)
    states = _common.uniform(
        g, (mix["warmup_solves"] + mix["max_solves"], meta.nx),
        mix["x0_half_width"], data.dtype, dev)
    for x in states[:mix["warmup_solves"]]:
        solver.solve(x, tol=cfg["tol"])
    _sync(dev)
    log(f"[bench] cold: {mix['warmup_solves']} warm-up solves")
    return dict(solver=solver, states=states[mix["warmup_solves"]:])


def window(run, st, log):
    dev, tol = run["device"], run["config"]["tol"]
    recs, walls = [], []
    retrials0 = _common.retrials()
    t0 = time.perf_counter()
    for i, x in enumerate(st["states"]):
        ts = time.perf_counter()
        with record_function("bench.cold_solve"):
            res = st["solver"].solve(x, tol=tol)
        _sync(dev)
        walls.append(time.perf_counter() - ts)
        recs.append((i, res.z.u[:, 0], res.z.s[0], res.z.x, res.z.u,
                     res.iterations, res.status))
        if time.perf_counter() - t0 >= run["seconds"]:
            break
    else:
        raise RuntimeError("the window used every state drawn: raise "
                           "max_solves")
    run["window_s"] = time.perf_counter() - t0
    if dev.type == "cuda":
        run["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    retrials1 = _common.retrials()
    run.update(retrial_lanes=retrials1[0] - retrials0[0],
               retrials=retrials1[1] - retrials0[1])
    iters = [int(r[5]) for r in recs]
    run.update(solve_s=walls, iterations=iters, solves=len(recs),
               attempted=len(recs),
               failed=sum(int(r[6]) != 0 for r in recs))
    log(f"[bench] window {run['window_s']:.3f} s: {len(recs)} cold solves, "
        f"iterations {iters}")
    st["recs"] = recs


def check(run, st, limits, log):
    from ..reference import checks

    recs = st["recs"]
    st["solver"] = None
    _common.free_program(run)
    P = _common.reference_problem(run)
    # the controls and objectives: a sample from the seed, with the solve
    # of the most iterations; the trajectories: every solve's
    rng = _common.host_rng(run, 4)
    n = min(run["mix"]["check_samples"], len(recs))
    pick = set(rng.choice(len(recs), size=n - 1, replace=False).tolist())
    pick.add(max(range(len(recs)), key=lambda j: run["iterations"][j]))
    pick = sorted(pick)
    x = st["states"][[recs[j][0] for j in pick]].double()
    sol = checks.reference(P, x, log)
    gap = checks.u_gap(sol, torch.stack([recs[j][1] for j in pick]).double())
    obj = checks.obj_gap(sol, torch.stack([recs[j][2] for j in pick]).double())
    dyn = checks.dyn_gap(P, torch.stack([r[3] for r in recs]),
                         torch.stack([r[4] for r in recs]))
    return dict(u_gap=(gap, limits["u_gap"]), obj_gap=(obj, limits["obj_gap"]),
                dyn_gap=(dyn, limits["dyn_gap"]))
