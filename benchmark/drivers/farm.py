"""The asynchronous MPC farm: ``mpc.simulate_async`` over B warm-started
chains, in CUDA-graph chunks, run after run.

Mix parameters: ``lanes`` (B), ``iters_per_launch`` (K, farm iterations a
graph replay), ``run_steps`` (S, the steps of one run: the source's
simulation length), ``x0_half_width`` (each run's states U(-h, h)),
``max_run_iters`` (a run's farm iterations at most: a lane still solving
then has stalled), ``check_samples`` (steps whose control is compared with
the reference, the step of the most iterations among them; lanes a run
whose returned trajectory is checked).

A run is one call of the program's farm: every lane starts from a fresh
state drawn from ``--seed`` and runs S steps with realizations drawn from
``--seed``, warm-started from the (z, v) the lane ended the previous run
with (the result's ``z``, ``v``, chained as the program offers); the call
ends when every lane has done its S steps.  Set-up runs the first step of
a run, every lane's first, cold solve, which builds every kernel and
captures the graph that the window's runs replay (one graph serves every
step count).  The window runs runs until
``--seconds`` have passed and finishes the run in flight, so no run is
cut; the harness keeps no result of the program across a call.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from . import _common


def _draw(run, st):
    """The next run's initial states [B, nx] and realizations [S, B]."""
    mix, meta, g = run["mix"], st["meta"], st["g"]
    x0 = _common.uniform(g, (mix["lanes"], meta.nx), mix["x0_half_width"],
                         st["data"].dtype, run["device"])
    ws = torch.randint(0, meta.tree.d, (mix["run_steps"], mix["lanes"]),
                       generator=g, device=run["device"])
    return x0, ws


def _farm_run(run, st, x0, ws, n_steps):
    """``n_steps`` steps of the program's farm from x0, chained from the
    previous run's (z, v).  Returns what the harness keeps of it: the records, the
    final states and (z, v) to chain from; the result itself is dropped."""
    from spock_tpu_torch import mpc

    mix = run["mix"]
    res = mpc.simulate_async(
        st["data"], st["meta"], x0, ws, run["config"]["tol"],
        n_steps=n_steps, iters_per_launch=mix["iters_per_launch"],
        max_total_iters=mix["max_run_iters"], z0=st["z"], v0=st["v"],
        device=run["device"])
    st["z"], st["v"] = res.z, res.v
    rec = dict(x0=x0, ws=ws, us=res.us, xs=res.xs, iters=res.iters_per_step,
               steps=res.steps_done, run=res.run)
    del res
    return rec


def setup(run, log):
    cfg, dev = run["config"], run["device"]
    data, meta = _common.build(run, log)
    st = dict(data=data, meta=meta, g=_common.generator(run), z=None, v=None)
    rec = _farm_run(run, st, *_draw(run, st), 1)
    stats = {k: rec["run"][k] for k in ("captures", "capture_s", "warmup_s")}
    stats["iterations"] = rec["run"]["counted"]
    run["setup_stats"] = stats
    log(f"[bench] farm B={run['mix']['lanes']} tol={cfg['tol']}: first "
        f"solves in {stats['iterations']} farm iterations, {stats['captures']} graph "
        f"captures ({stats['capture_s']:.3f} s), {stats['warmup_s']:.3f} s "
        f"of throwaway iterations")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return st


def window(run, st, log):
    from spock_tpu_torch.ops import spstep

    dev, mix = run["device"], run["mix"]
    launches0 = dict(spstep.LAUNCHES)
    retrials0 = spstep.retrials()
    rng = _common.host_rng(run, 3)
    recs, zs = [], []
    t0 = time.perf_counter()
    while True:
        x0, ws = _draw(run, st)
        with record_function("bench.farm_run"):
            rec = _farm_run(run, st, x0, ws, mix["run_steps"])
        # the trajectories a few lanes returned, for the check
        lanes = torch.as_tensor(rng.choice(mix["lanes"], size=min(
            mix["check_samples"], mix["lanes"]), replace=False), device=dev)
        zs.append((st["z"].x[lanes].clone(), st["z"].u[lanes].clone()))
        recs.append(rec)
        if time.perf_counter() - t0 >= run["seconds"]:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    run["window_s"] = time.perf_counter() - t0
    if dev.type == "cuda":
        run["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    retrials1 = spstep.retrials()
    S = mix["run_steps"]
    steps = torch.stack([r["steps"] for r in recs])  # [R, B]
    iters = torch.stack([r["iters"] for r in recs])  # [R, S, B]
    solves = int(steps.sum())
    stalled = int((steps < S).sum())
    counted = sum(r["run"]["counted"] for r in recs)
    executed = sum(r["run"]["executed"] for r in recs)
    run.update(
        solves=solves, solve_iterations=int(iters.sum()),
        farm_iterations=counted, executed=executed,
        chunks=sum(r["run"]["chunks"] for r in recs), runs=len(recs),
        lanes=mix["lanes"],
        launches={k: spstep.LAUNCHES[k] - launches0[k] for k in launches0},
        retrial_lanes=retrials1[0] - retrials0[0],
        retrials=retrials1[1] - retrials0[1],
        attempted=solves + stalled, failed=stalled)
    log(f"[bench] window {run['window_s']:.3f} s: {len(recs)} runs, "
        f"{solves} solves, {counted} farm iterations ({executed} executed) "
        f"in {run['chunks']} graph replays, {run['solve_iterations']} solve "
        f"iterations; iterations a step {iters.float().mean((0, 2)).tolist()}")
    st.update(recs=recs, zs=zs, z=None, v=None)


def check(run, st, limits, log):
    from ..reference import checks, mpc

    _common.free_program(run)
    P = _common.reference_problem(run)
    recs, S = st["recs"], run["mix"]["run_steps"]
    f = torch.float64
    x0 = torch.cat([r["x0"] for r in recs])  # [R B, nx]
    xs = torch.cat([r["xs"] for r in recs])
    us = torch.cat([r["us"].transpose(0, 1) for r in recs])  # [R B, S, nu]
    ws = torch.cat([r["ws"].transpose(0, 1) for r in recs])  # [R B, S]
    steps = torch.cat([r["steps"] for r in recs])
    iters = torch.cat([r["iters"].transpose(0, 1) for r in recs])  # [R B, S]
    # the plant: every lane of every run, from its drawn state to its last
    plant = checks.plant_replay_gap(P, x0, xs, us, ws, steps)
    # the controls: a sample of the completed steps drawn from the seed,
    # with the step of the most iterations; each at the state that the
    # applied controls lead to, replayed in float64
    done = torch.arange(S, device=steps.device)[None] < steps[:, None]
    cand = torch.nonzero(done).tolist()
    numbers = dict(stalled_lanes=(run["failed"], limits["stalled_lanes"]),
                   plant_gap=(plant, limits["plant_gap"]))
    if cand:  # none where every lane stalled: stalled_lanes fails then
        rng = _common.host_rng(run, 1)
        n = min(run["mix"]["check_samples"], len(cand))
        pick = {tuple(cand[j]) for j in rng.choice(len(cand), size=n - 1,
                                                    replace=False)}
        pick.add(divmod(int(torch.argmax(torch.where(done, iters, -1))), S))
        pick = sorted(pick)
        states = []
        for lane, t in pick:
            x = x0[lane].to(f)[None]
            for k in range(t):
                x = mpc.plant(P, x, us[lane, k].to(f)[None],
                              ws[lane, k][None])
            states.append(x[0])
        ua = torch.stack([us[lane, t] for lane, t in pick]).to(f)
        sol = checks.reference(P, torch.stack(states), log)
        numbers["u_gap"] = (checks.u_gap(sol, ua), limits["u_gap"])
    # the trajectories that the sampled lanes returned at the end of a run
    dyn = checks.dyn_gap(P, torch.cat([z[0] for z in st["zs"]]),
                         torch.cat([z[1] for z in st["zs"]]))
    numbers["dyn_gap"] = (dyn, limits["dyn_gap"])
    return numbers
