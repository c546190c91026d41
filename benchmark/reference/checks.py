"""The numbers that decide ``correct``: what the timed path produced, judged
in float64 by the plain reference.  Imports nothing of the program; reads
its outputs only.

* ``u_gap``: the widest gap between a control the program applied and the
  reference's optimal control at the same state.
* ``obj_gap``: the widest gap between the program's objective s_0 and the
  reference's optimal value, relative to max(1, |value|).
* ``plant_gap``: the program's plant states against x+ = A[w] x + B[w] u
  replayed in float64 from its own earlier state and applied controls, as
  a relative error a step: the gap after k steps over the bound
  a_k = |A_w|(a_{k-1} + |x_{k-1}|) + |B_w||u_{k-1}| (a_0 = 0, inf-norms)
  that k steps can reach when each step errs by that step's
  |A_w||x| + |B_w||u| times e; the reading is that e.
* ``dyn_gap``: the widest violation, over the edges of the tree, of
  x_j = A_k x_i + B_k u_i by the primal trajectory a solve returned, over
  the widest |A_k||x_i| + |B_k||u_i| of that solve (inf-norms).

A float32 computation reads about 1e-7 in the last two, a TF32 one about
5e-4: they hold the precision.  The first two hold the solve to its
tolerance.
"""

from __future__ import annotations

import time

import torch

from . import mpc


def reference(P: mpc.Problem, x, log=None) -> mpc.Solution:
    """The reference's optimum at the states x [S, nx]; raises if it did
    not converge."""
    t0 = time.perf_counter()
    sol = mpc.solve(P, x)
    if log:
        log(f"[reference] {x.shape[0]} solves in "
            f"{time.perf_counter() - t0:.3f} s: {sol.outer} weight updates, "
            f"{sol.newton} interior-point iterations, converged "
            f"{sol.converged}")
    if not sol.converged:
        raise RuntimeError("the reference did not converge")
    return sol


def u_gap(sol: mpc.Solution, u_prog, idx=None) -> float:
    """Widest gap of the applied controls u_prog [M, nu] from the optimal
    ones (of the reference's states ``idx``, default all in order)."""
    u0 = sol.u0 if idx is None else sol.u0[idx]
    u_prog = torch.as_tensor(u_prog, dtype=u0.dtype, device=u0.device)
    return float((u_prog - u0).abs().max())


def obj_gap(sol: mpc.Solution, s0_prog, idx=None) -> float:
    value = sol.value if idx is None else sol.value[idx]
    s0 = torch.as_tensor(s0_prog, dtype=value.dtype, device=value.device)
    return float(((s0 - value).abs()
                  / torch.clamp(value.abs(), min=1.0)).max())


def plant_replay_gap(P: mpc.Problem, x_start, x_end, us, ws, steps) -> float:
    """Per-step plant error over M stretches: x_start, x_end [M, nx] the
    program's states at both ends, us [M, K, nu] and ws [M, K] the controls
    and realizations of each stretch's steps, ``steps`` [M] how many of the
    K each stretch has (0 skips it)."""
    f = P.A.dtype
    x = x_start.to(f)
    amp = torch.zeros(x.shape[0], dtype=f, device=x.device)
    a_inf, b_inf = _inf(P.A), _inf(P.B)
    for k in range(us.shape[1]):
        live = k < steps
        if not bool(live.any()):
            break
        w = ws[:, k].clamp(min=0)
        u = us[:, k].to(f)
        nxt = mpc.plant(P, x, u, w)
        step = a_inf[w] * x.abs().amax(-1) + b_inf[w] * u.abs().amax(-1)
        amp = torch.where(live, a_inf[w] * amp + step, amp)
        x = torch.where(live[:, None], nxt, x)
    done = (steps > 0) & (amp > 0)
    if not bool(done.any()):
        return 0.0
    gap = (x_end.to(f) - x).abs().amax(-1)
    return float((gap[done] / amp[done]).max())


def _inf(M):
    """Inf-norms of a stack of matrices [d, a, b] -> [d]."""
    return M.abs().sum(-1).amax(-1)


def plant_gap(P: mpc.Problem, x, u, w, x_next) -> float:
    """One step a row: the relative error of x_next [M, nx] against
    A[w] x + B[w] u in float64."""
    f = P.A.dtype
    x, u, x_next = x.to(f), u.to(f), x_next.to(f)
    gap = (x_next - mpc.plant(P, x, u, w)).abs().amax(-1)
    scale = (_inf(P.A)[w] * x.abs().amax(-1)
             + _inf(P.B)[w] * u.abs().amax(-1))
    keep = scale > 0
    return float((gap[keep] / scale[keep]).max()) if bool(keep.any()) else 0.0


def dyn_gap(P: mpc.Problem, zx, zu) -> float:
    """zx [S, nx, n] and zu [S, nu, n_nonleaf]: the program's primal states
    and inputs, node axis last, stage-major and sibling-major within a
    stage (the layout of ``mpc``)."""
    f = P.A.dtype
    zx, zu = zx.to(f), zu.to(f)
    S = zx.shape[0]
    gap = torch.zeros(S, dtype=f, device=zx.device)
    scale = torch.zeros(S, dtype=f, device=zx.device)
    a, b = float(_inf(P.A).max()), float(_inf(P.B).max())
    off = 0
    for t in range(P.N - 1):
        n = P.d ** t
        x = zx[:, :, off:off + n].transpose(1, 2)
        u = zu[:, :, off:off + n].transpose(1, 2)
        child = zx[:, :, off + n:off + n + P.d * n].transpose(1, 2)
        pred = mpc.children(P, x, u)
        gap = torch.maximum(gap, (child - pred).abs().amax((1, 2)))
        scale = torch.maximum(scale, a * x.abs().amax((1, 2))
                              + b * u.abs().amax((1, 2)))
        off += n
    keep = scale > 0
    return float((gap[keep] / scale[keep]).max()) if bool(keep.any()) else 0.0
