"""One plant in closed loop: each step is ``Solver.solve`` warm-started from
the last (z, v), then the plant update ``x+ = A[w] x + B[w] u`` of the
program's MPC layer, ending in ``torch.cuda.synchronize()``.

Mix parameters: ``x0_half_width`` (the plant's state is drawn from U(-h, h)
at the start of every run), ``run_steps`` (S, the steps of a run: the
source's simulation length; the controller keeps its warm start across a
run's start, the plant's state jumps), ``warmup_steps`` (steps before the
window, the first a cold solve), ``max_steps_per_second`` (a bound above
the window's steps: the draws made), ``check_samples`` (steps whose
control is compared with the reference, the step with the most
iterations among them).  The states and realizations are drawn from
``--seed``.

The window starts a run and ends with the first run that ends after
``--seconds``: it holds whole runs.  Every step is timed by the host
clock; the plant's states, the applied controls and each solve's primal
trajectory are kept for the check.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from ..core import quantile
from . import _common


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def setup(run, log):
    from spock_tpu_torch import Solver

    mix, dev = run["mix"], run["device"]
    data, meta = _common.build(run, log)
    solver = Solver(data, meta, algorithm="spock", device=dev)
    g = _common.generator(run)
    rows = (int(mix["max_steps_per_second"] * run["seconds"])
            + mix["warmup_steps"] + 2)
    starts = _common.uniform(g, (rows // mix["run_steps"] + 1, meta.nx),
                             mix["x0_half_width"], data.dtype, dev)
    ws = torch.randint(0, meta.tree.d, (rows,), generator=g, device=dev)
    st = dict(data=data, meta=meta, solver=solver, starts=starts, x=None,
              z=None, v=None, ws=ws, k=0, runs=0, since=0)
    for _ in range(mix["warmup_steps"]):
        _step(run, st)
    st["since"] = 0  # the window starts a run
    _sync(dev)
    log(f"[bench] loop: {mix['warmup_steps']} steps, the first cold; a new "
        f"state every {mix['run_steps']} steps")
    return st


def _step(run, st):
    from spock_tpu_torch import mpc

    if st["since"] == 0:
        st["x"] = st["starts"][st["runs"]][None]
        st["runs"] += 1
    with record_function("bench.solve"):
        res = st["solver"].solve(st["x"], z0=st["z"], v0=st["v"],
                                 tol=run["config"]["tol"])
    u = res.z.u[:, :, 0]
    with record_function("bench.plant"):
        x_next = mpc._plant(st["data"], st["x"], u, st["ws"][st["k"]][None])
    rec = (st["x"][0], u[0], x_next[0], st["k"],
           (res.iterations[0], res.status[0], res.z.x[0], res.z.u[0]))
    st.update(x=x_next, z=res.z, v=res.v, k=st["k"] + 1,
              since=(st["since"] + 1) % run["mix"]["run_steps"])
    return rec


def window(run, st, log):
    dev = run["device"]
    times, recs = [], []
    retrials0 = _common.retrials()
    t0 = time.perf_counter()
    while True:
        if (st["k"] >= st["ws"].shape[0]
                or st["runs"] >= st["starts"].shape[0] and st["since"] == 0):
            raise RuntimeError("the window used every realization drawn: "
                               "raise max_steps_per_second")
        ts = time.perf_counter()
        rec = _step(run, st)
        _sync(dev)
        t1 = time.perf_counter()
        times.append(t1 - ts)
        recs.append(rec)
        if t1 - t0 >= run["seconds"] and st["since"] == 0:
            break
    run["window_s"] = time.perf_counter() - t0
    if dev.type == "cuda":
        run["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    retrials1 = _common.retrials()
    run.update(retrial_lanes=retrials1[0] - retrials0[0],
               retrials=retrials1[1] - retrials0[1])
    iters = [int(r[4][0]) for r in recs]
    status = [int(r[4][1]) for r in recs]
    ms = [1e3 * t for t in times]
    run.update(step_s=times, iterations=iters, attempted=len(recs),
               failed=sum(s != 0 for s in status), solves=len(recs))
    log(f"[bench] window {run['window_s']:.3f} s: {len(recs)} steps in "
        f"{len(recs) // run['mix']['run_steps']} runs, "
        f"{sum(iters)} iterations; step ms mean "
        f"{sum(ms) / len(ms):.3f} median {quantile(ms, 0.5):.3f} p90 "
        f"{quantile(ms, 0.9):.3f} p95 {quantile(ms, 0.95):.3f} p99 "
        f"{quantile(ms, 0.99):.3f}")
    log(f"[bench] steps (k, iterations, ms): "
        f"{[(r[3], i, round(m, 2)) for r, i, m in zip(recs, iters, ms)]}")
    st["recs"] = recs


def check(run, st, limits, log):
    from ..reference import checks

    recs = st["recs"]
    for k in ("solver", "z", "v"):
        st[k] = None
    _common.free_program(run)
    P = _common.reference_problem(run)
    f = torch.float64
    # the plant, at every step of the window
    x = torch.stack([r[0] for r in recs]).to(f)
    u = torch.stack([r[1] for r in recs]).to(f)
    nxt = torch.stack([r[2] for r in recs]).to(f)
    w = st["ws"][torch.tensor([r[3] for r in recs], device=x.device)]
    plant = checks.plant_gap(P, x, u, w, nxt)
    # the controls and trajectories: a sample from the seed, with the step
    # that took the most iterations
    rng = _common.host_rng(run, 2)
    n = min(run["mix"]["check_samples"], len(recs))
    pick = set(rng.choice(len(recs), size=n - 1, replace=False).tolist())
    pick.add(max(range(len(recs)), key=lambda i: run["iterations"][i]))
    pick = sorted(pick)
    gap = checks.u_gap(checks.reference(P, x[pick], log), u[pick])
    zx = torch.stack([recs[i][4][2] for i in pick])
    zu = torch.stack([recs[i][4][3] for i in pick])
    dyn = checks.dyn_gap(P, zx, zu)
    return dict(u_gap=(gap, limits["u_gap"]),
                plant_gap=(plant, limits["plant_gap"]),
                dyn_gap=(dyn, limits["dyn_gap"]))
