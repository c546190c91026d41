"""Receding-horizon MPC simulation with warm starting.

:func:`simulate` advances B plants in lockstep: at each step it solves from
the current states, applies the root inputs, advances the plants with the
given realizations, and warm-starts the next solve from the previous
primal-dual iterate.  :func:`simulate_async` is the asynchronous farm: each
lane starts its next warm-started solve the moment its current one
converges, so throughput follows the mean iteration count, not the
slowest lane.  The JAX package's ``lax.scan`` and ``lax.while_loop`` are
host loops here, with one device-to-host sync per farm iteration.

``fused_sweep`` chooses the CP sweep of the solvers (see
:mod:`spock_tpu_torch.algorithms.supermann`): one kernel launch per sweep by
default, the composed path when False.  ``fused_step`` (default True) runs
each SuperMann iteration as one kernel launch where the fused step covers the
configuration (``supermann.use_fused_step``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .algorithms import cp as cp_alg
from .algorithms import supermann as sp_alg
from .problem import ProblemData, ProblemMeta
from .solver import check_device, zero_dual, zero_primal
from .zv import tmap


def _plant(data: ProblemData, x, u, w):
    """x+ = A[w] x + B[w] u per lane; x: [B, nx], u: [B, nu], w: [B]."""
    return (torch.matmul(data.A[w], x[..., None])
            + torch.matmul(data.B[w], u[..., None]))[..., 0]


@dataclasses.dataclass(frozen=True)
class MPCResult:
    xs: Any  # [T+1, B, nx] closed-loop states
    us: Any  # [T, B, nu] applied inputs
    iterations: Any  # [T, B] solver iterations per step
    status: Any  # [T, B]
    objective: Any  # [T, B] s_root per step


def simulate(data: ProblemData, meta: ProblemMeta, x0, ws, tol,
             algorithm: str = "spock", max_iter: int = 1000,
             opts: sp_alg.SuperMannOpts = sp_alg.SuperMannOpts(),
             device=None, fused_sweep: bool = True,
             fused_step: bool = True) -> MPCResult:
    """Closed-loop simulation.  x0: [B, nx] initial states; ws: [T, B] int
    realization indices; tol: solver tolerance per step."""
    device = check_device(data, device)
    x = torch.as_tensor(x0, dtype=data.dtype, device=device)
    ws = torch.as_tensor(ws, dtype=torch.int64, device=device)
    B = x.shape[0]
    z = zero_primal(meta, (B,), data.dtype, device)
    v = zero_dual(meta, (B,), data.dtype, device)
    xs, us, iters, status, obj = [x], [], [], [], []
    for w in ws:
        if algorithm == "spock":
            res = sp_alg.run_supermann(data, meta, x, z, v, tol=tol,
                                       max_iter=max_iter, opts=opts,
                                       fused_sweep=fused_sweep,
                                       fused_step=fused_step)
        else:
            res = cp_alg.run_cp(data, meta, x, z, v, tol=tol,
                                max_iter=max_iter, fused_sweep=fused_sweep)
        u0 = res.z.u[:, :, 0]
        x = _plant(data, x, u0, w)
        z, v = res.z, res.v
        xs.append(x)
        us.append(u0)
        iters.append(res.iterations)
        status.append(res.status)
        obj.append(res.z.s[:, 0])
    return MPCResult(xs=torch.stack(xs), us=torch.stack(us),
                     iterations=torch.stack(iters),
                     status=torch.stack(status), objective=torch.stack(obj))


@dataclasses.dataclass(frozen=True)
class AsyncMPCResult:
    steps_done: Any  # [B] MPC steps completed per lane
    iters_per_step: Any  # [T, B] solver iterations per completed step
    us: Any  # [T, B, nu] applied inputs per step
    xs: Any  # [B, nx] final states
    total_iterations: int  # farm iterations executed
    z: Any  # final primal state (chain into another run)
    v: Any  # final dual state


def simulate_async(
    data: ProblemData,
    meta: ProblemMeta,
    x0,
    ws,
    tol,
    n_steps: int,
    opts: sp_alg.SuperMannOpts = sp_alg.SuperMannOpts(),
    max_total_iters: int = 1_000_000,
    z0=None,
    v0=None,
    device=None,
    fused_sweep: bool = True,
    fused_step: bool = True,
) -> AsyncMPCResult:
    """Asynchronous MPC farm of B lanes, each running ``n_steps`` warm-started
    solves of its own chain.

    x0: [B, nx]; ws: [T, B] realization indices (T >= n_steps); z0/v0: the
    warm start of every lane (default zeros).  Stops when every lane has done
    ``n_steps`` steps or after ``max_total_iters`` farm iterations.
    """
    device = check_device(data, device)
    dtype = data.dtype
    x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    ws = torch.as_tensor(ws, dtype=torch.int64, device=device)
    B = x0.shape[0]
    T = ws.shape[0]
    if n_steps > T:
        raise ValueError(f"n_steps={n_steps} exceeds the {T} realization rows")
    if z0 is None:
        z0 = zero_primal(meta, (B,), dtype, device)
    if v0 is None:
        v0 = zero_dual(meta, (B,), dtype, device)
    fused = sp_alg.use_fused_step(data, meta, opts, fused_sweep, fused_step)
    if fused:
        # one sp_step_fused launch per iteration, the history phase bound to
        # the carry's iteration count
        sp = sp_alg.sp_init_fused(meta, x0, z0, v0, opts)
        bodies = [sp_alg.sp_body_fused(data, meta, tol, opts, phase=ph)
                  for ph in range(3)]
    else:
        sp = sp_alg.sp_init(meta, x0, z0, v0, opts)
        bodies = [sp_alg.sp_body(data, meta, tol, opts,
                                 fused_sweep=fused_sweep)]
    lanes = torch.arange(B, device=device)
    step_idx = torch.zeros((B,), dtype=torch.int64, device=device)
    iters_rec = torch.zeros((T, B), dtype=torch.int32, device=device)
    us_rec = torch.zeros((T, B, meta.nu), dtype=dtype, device=device)
    total = 0
    while total < max_total_iters and bool((step_idx < n_steps).any()):
        sp = bodies[sp.it % len(bodies)](sp)
        # lanes whose current solve just converged and still have steps to do
        fin = sp.done & (step_idx < n_steps)
        u0 = sp_alg.root_u_carry(sp)
        row = torch.clamp(step_idx, max=T - 1)
        iters_rec[row, lanes] += torch.where(fin, sp.niter, 0).to(torch.int32)
        us_rec[row, lanes] += torch.where(fin[:, None], u0, 0.0)
        # plant update with each lane's own realization sequence
        x_next = _plant(data, sp.x0, u0, ws[row, lanes])
        step_idx = step_idx + fin.to(torch.int64)
        # Refill: the plant advances; res0, r_safe, eta and niter reset;
        # cache_valid is cleared (the cached sweep pinned the old x0).  The
        # Anderson memory needs no reset: niter = 0 masks the stale
        # r_prev/s_prev reads, and the Anderson rows older than the current
        # solve drop out by their validity (row j of the newest-first history,
        # or the row of age j of the fused carry, counts iff j <= niter).  The
        # Broyden ring is zeroed per lane.
        repl = dict(
            x0=torch.where(fin[:, None], x_next, sp.x0),
            done=sp.done & ~(fin & (step_idx < n_steps)),
            res0=torch.where(fin[:, None], float("-inf"), sp.res0),
            r_safe=torch.where(fin, float("inf"), sp.r_safe),
            niter=torch.where(fin, 0, sp.niter).to(torch.int32),
            cache_valid=sp.cache_valid & ~fin,
        )
        if not fused:
            repl["eta"] = torch.where(fin, float("inf"), sp.eta)
        if opts.direction == "broyden":
            repl["dirstate"] = tmap(
                lambda a: torch.where(
                    fin.reshape(fin.shape + (1,) * (a.ndim - 1)),
                    torch.zeros_like(a), a),
                sp.dirstate)
        sp = dataclasses.replace(sp, **repl)
        total += 1
    return AsyncMPCResult(
        steps_done=step_idx,
        iters_per_step=iters_rec,
        us=us_rec,
        xs=sp.x0,
        total_iterations=total,
        z=sp.z,
        v=sp.v,
    )
