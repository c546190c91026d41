"""SuperMann-globalized Chambolle-Pock with quasi-Newton directions (SPOCK).

The CP operator is wrapped as the fixed-point residual r = (z - zbar,
v - vbar); each iteration makes a quasi-Newton candidate (z, v) + tau d and
accepts it by the K1 (educated) or K2 (GKM safeguard) rule, falling back to a
plain relaxed CP step.  Norms and inner products use the CP metric
M = [[I, -gamma L'], [-sigma L, I]].  Backtracking shrinks tau geometrically
(tau <- beta tau); rho = <r~, M r~> - tau <r~, M d> with M d computed once per
iteration.

Every decision is lane-masked over the batch axis.  The JAX package's
``lax.while_loop``s are host loops here, on a lane mask; the batch-wide
cache test is a Python ``if`` on one ``.all()``.  Directions: "anderson",
"broyden" and "residual".

``fused_sweep`` (default True) chooses the sweep: one kernel launch per CP
sweep where the sweep kernels cover the problem (``common.cp_sweep_metric``,
``candidate_sweep``, ``metric_pair``), the composed path of PyTorch operators
and the prox_h* kernel otherwise or when False.  It is the counterpart of the
JAX package's ``SPOCK_PALLAS_SWEEP``, given as an argument.

``fused_step`` (default True) takes the whole iteration into one kernel
launch (``ops.spstep.sp_step_fused``) where :func:`use_fused_step` holds:
Anderson window 3, no K0, the fused sweep, a problem the kernels cover.  Its
carry is :class:`SPCarryF`, driven by :func:`sp_body_fused` in a 3-phase
unroll; the backtracking of an iteration is one
``ops.spstep.sp_step_backtrack`` launch in which each lane still looping
makes its own trials at its shrunken tau.  An iteration of the fused step
reads nothing on the host, so a CUDA graph can hold it
(``mpc.simulate_async``'s ``iters_per_launch``).
It is the counterpart of the JAX package's ``SPOCK_FUSED_STEP``.

``record`` keeps a per-iteration trace of (xi1, xi2, backtracking rounds)
on the carry, written in place at row ``it``: [max_iter, B, 3] on the
composed body and [max_iter + 2, B, 3] on the fused one, as in the JAX
package.  The rounds are batch-wide: the retrial rounds the iteration ran,
which is the most trials any lane made.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..ops import spstep, sweep_kernels
from ..problem import ProblemData, ProblemMeta, step_size
from ..utils import profiling
from ..zv import Dual, Primal, leaves, lincomb, sub, tmap
from . import anderson, broyden
from .common import (
    PLAIN,
    Ops,
    SolveResult,
    bexpand,
    bwhere,
    candidate_sweep,
    check_termination,
    cp_sweep_metric,
    metric_pair,
)


@dataclasses.dataclass(frozen=True)
class SuperMannOpts:
    """Tuning knobs (the JAX package's defaults)."""

    c0: float = 0.99
    c1: float = 0.99
    q: float = 0.99
    sigma_k2: float = 0.1
    beta: float = 0.5
    max_backtracks: int = 8
    lam: float = 1.0  # CP fallback relaxation
    lam_sp: float = 1.0  # K2 projection relaxation
    aa_window: int = 3  # Anderson window
    k0: bool = False  # blind updates
    direction: str = "anderson"  # "anderson" | "broyden" | "residual"
    broyden_mem: int = 20  # Broyden restart length


@dataclasses.dataclass(frozen=True)
class SPCarry:
    x0: Any  # [B, nx] per-lane initial state (rewritten by the farm)
    z: Primal
    v: Dual
    r_prev: Any  # (Primal, Dual) previous residual
    s_prev: Any  # (Primal, Dual) z_k - z_{k-1}
    dirstate: Any  # Anderson histories (MR, MP), Broyden ring, or ()
    r_safe: Any  # [B]
    eta: Any  # [B] K0 threshold
    res0: Any  # [B, 2]
    done: Any  # [B] bool
    niter: Any  # [B] int32
    xi1: Any  # [B]
    xi2: Any  # [B]
    it: int  # iterations run on this carry
    # sweep cache: a lane that accepted the tau=1 K1 candidate has that
    # candidate's sweep results as the next iteration's (zbar, vbar, ||r||,
    # inf-norms); they are reused when every lane's cache is valid.
    cache_valid: Any  # [B] bool
    zbar_c: Primal
    vbar_c: Dual
    rnorm_c: Any  # [B]
    nMrz_c: Any  # [B]
    nMrv_c: Any  # [B]
    hist: Any = None  # [max_iter, B, 3] trace with record=True, else None


def _record(hist, it: int, xi1, xi2, rounds) -> None:
    """Row ``it`` of the trace: (xi1, xi2, rounds), rounds a 0-d tensor or
    an int; written in place, with no host sync."""
    hist[it] = torch.stack(
        [xi1, xi2, torch.as_tensor(rounds, dtype=xi1.dtype,
                                   device=xi1.device).expand_as(xi1)],
        dim=-1)


def _ravel_pair(z: Primal, v: Dual):
    """(Primal, Dual) with leaves [B, ...] -> one flat [B, K] tensor."""
    ls = leaves((z, v))
    B = ls[0].shape[0]
    return torch.cat([a.reshape(B, -1) for a in ls], dim=-1)


def _unravel_pair(flat, like_z: Primal, like_v: Dual):
    """Inverse of :func:`_ravel_pair` onto the layout of (like_z, like_v);
    the leaves are contiguous copies, as the kernels take them."""
    off = 0

    def take(a):
        nonlocal off
        size = a[0].numel()
        out = flat[:, off:off + size].reshape(a.shape).contiguous()
        off += size
        return out

    return tmap(take, like_z), tmap(take, like_v)


def _make_candidate(data, meta, x0, z, v, dz, dv, rnorm, q_pow, opts, gamma,
                    sigma, fused_sweep, ops=PLAIN):
    """The one-backtracking-trial closure at per-lane step size tau.

    Returns the updated acceptance state plus the candidate's sweep results
    (the tau=1 trial's become the next iteration's cache)."""
    # d does not change between trials: the composed path computes M d once;
    # the candidate kernel computes it in every launch without storing it
    Md = None
    if not (ops.kernels and fused_sweep
            and sweep_kernels.supported(meta, data)):
        Md = metric_pair(data, meta, dz, dv, gamma, sigma, fused=False,
                         ops=ops)

    def candidate(tau, looping, b_z_acc, b_v_acc, b_r_safe, b_xi1, b_xi2):
        (wbar, ubar, _Mrw, _Mru, rt_sq, nMrwz, nMrwv, rho_dot, nMdz,
         nMdv) = candidate_sweep(data, meta, z, v, dz, dv, tau, gamma, sigma,
                                 x0, Md=Md, fused=fused_sweep, ops=ops)
        w = tmap(lambda zl, dl: zl + bexpand(tau, zl) * dl, z, dz)
        u = tmap(lambda vl, dl: vl + bexpand(tau, vl) * dl, v, dv)
        rw = sub(w, wbar)
        ru = sub(u, ubar)
        rt_sq = torch.clamp(rt_sq, min=0.0)
        rtilde = torch.sqrt(rt_sq)
        rho = rt_sq - tau * rho_dot

        k1 = (rnorm <= b_r_safe) & (rtilde <= opts.c1 * rnorm) & looping
        k2 = (rho >= opts.sigma_k2 * rnorm * rtilde) & looping & (~k1)
        # K2 safeguarded projection step
        pos = rt_sq > 0
        coef = torch.where(
            pos, rho / torch.where(pos, rt_sq, torch.ones_like(rt_sq)),
            torch.zeros_like(rho))
        coef = opts.lam_sp * coef
        z_k2 = tmap(lambda zl, rl: zl - bexpand(coef, zl) * rl, z, rw)
        v_k2 = tmap(lambda vl, rl: vl - bexpand(coef, vl) * rl, v, ru)

        z_acc = bwhere(k1, w, bwhere(k2, z_k2, b_z_acc))
        v_acc = bwhere(k1, u, bwhere(k2, v_k2, b_v_acc))
        r_safe = torch.where(k1, rtilde + q_pow, b_r_safe)
        # Operator-free termination residuals at acceptance:
        #   K1: dz_iter = tau*d  => xi1 = tau*||M dz||_inf/gamma
        #   K2: dz_iter = -coef*rw => xi1 = coef*||M rw||_inf/gamma
        xi1 = torch.where(k1, tau * nMdz / gamma,
                          torch.where(k2, coef * nMrwz / gamma, b_xi1))
        xi2 = torch.where(k1, tau * nMdv / sigma,
                          torch.where(k2, coef * nMrwv / sigma, b_xi2))
        looping_out = looping & (~k1) & (~k2)
        return ((z_acc, v_acc, r_safe, xi1, xi2, looping_out, k1),
                (wbar, ubar, rtilde, nMrwz, nMrwv))

    return candidate


@dataclasses.dataclass
class _BTState:
    tau: Any  # [B]
    looping: Any  # [B]
    z_acc: Primal
    v_acc: Dual
    r_safe: Any  # [B]
    xi1: Any  # [B] termination residual at the accepted update
    xi2: Any  # [B]
    bt: int


def _run_backtracks(candidate, opts, looping1, z_a, v_a, r_safe_a, xi1_a,
                    xi2_a, dtype):
    """Geometric backtracking for lanes still looping after the tau=1 trial."""
    b = _BTState(
        tau=torch.full(looping1.shape, opts.beta, dtype=dtype,
                       device=looping1.device),
        looping=looping1, z_acc=z_a, v_acc=v_a, r_safe=r_safe_a, xi1=xi1_a,
        xi2=xi2_a, bt=1,
    )
    while b.bt <= opts.max_backtracks and bool(b.looping.any()):
        (z_acc, v_acc, r_safe, xi1, xi2, looping, _), _unused = candidate(
            b.tau, b.looping, b.z_acc, b.v_acc, b.r_safe, b.xi1, b.xi2)
        b = _BTState(
            tau=torch.where(looping, b.tau * opts.beta, b.tau),
            looping=looping, z_acc=z_acc, v_acc=v_acc, r_safe=r_safe, xi1=xi1,
            xi2=xi2, bt=b.bt + 1,
        )
    return b


def sp_init(meta: ProblemMeta, x0, z0: Primal, v0: Dual,
            opts: SuperMannOpts = SuperMannOpts(), max_iter: int = 1000,
            record: bool = False) -> SPCarry:
    """The initial SuperMann carry for a batch of lanes (with ``record``, a
    zero [max_iter, B, 3] trace)."""
    B = x0.shape[0]
    dtype, device = x0.dtype, x0.device
    if opts.direction == "anderson":
        # newest-first histories: one (Primal, Dual)-shaped tree per window
        # row, leaves [B, m, *event]
        def hzeros(l):
            return torch.zeros((B, opts.aa_window) + tuple(l.shape[1:]),
                               dtype=dtype, device=device)

        dirstate0 = (tmap(hzeros, (z0, v0)), tmap(hzeros, (z0, v0)))
    elif opts.direction == "broyden":
        K = _ravel_pair(z0, v0).shape[-1]
        dirstate0 = broyden.init(B, K, opts.broyden_mem, dtype, device)
    elif opts.direction == "residual":
        dirstate0 = ()
    else:
        raise ValueError(f"unknown direction {opts.direction!r}")

    def full(value, dt=dtype):
        return torch.full((B,), value, dtype=dt, device=device)

    zpair = (tmap(torch.zeros_like, z0), tmap(torch.zeros_like, v0))
    return SPCarry(
        x0=x0,
        z=z0,
        v=v0,
        r_prev=zpair,
        s_prev=zpair,
        dirstate=dirstate0,
        r_safe=full(float("inf")),
        eta=full(float("inf")),
        res0=torch.full((B, 2), float("-inf"), dtype=dtype, device=device),
        done=full(False, torch.bool),
        niter=full(0, torch.int32),
        xi1=full(float("inf")),
        xi2=full(float("inf")),
        it=0,
        cache_valid=full(False, torch.bool),
        zbar_c=tmap(torch.zeros_like, z0),
        vbar_c=tmap(torch.zeros_like, v0),
        rnorm_c=full(0.0),
        nMrz_c=full(0.0),
        nMrv_c=full(0.0),
        hist=(torch.zeros((max_iter, B, 3), dtype=dtype, device=device)
              if record else None),
    )


def sp_body(data: ProblemData, meta: ProblemMeta, tol,
            opts: SuperMannOpts = SuperMannOpts(), gamma=None, sigma=None,
            fused_sweep: bool = True, record: bool = False, constrain=None,
            ops: Ops = PLAIN):
    """Returns the one-iteration transition function carry -> carry, for
    outer drivers (the async MPC farm) to embed in their own loops.  With
    ``record`` the carry's trace (from ``sp_init(record=True)``) gets the
    iteration's row.  ``constrain``: an optional ``tree -> tree`` hook
    applied to the carry's (z, v) at the start of every iteration.
    ``ops``: the operators (``common.Ops``; ``parallel.bigtree`` gives
    node-sharded ones, which Broyden's flat state cannot take)."""
    if opts.direction not in ("anderson", "broyden", "residual"):
        raise ValueError(f"unknown direction {opts.direction!r}")
    if ops is not PLAIN and opts.direction == "broyden":
        raise ValueError("Broyden keeps a flat [B, K] state over the whole "
                         "pair: it takes the plain operators only")
    if gamma is None or sigma is None:
        gamma = sigma = step_size(data)
    tol = float(tol)

    def body(c: SPCarry) -> SPCarry:
        if constrain is not None:
            c = dataclasses.replace(c, z=constrain(c.z), v=constrain(c.v))
        B = c.done.shape[0]
        dtype, device = c.r_safe.dtype, c.r_safe.device
        x0 = c.x0
        # ---- CP sweep + fixed-point residual; batch-wide cache use:
        # recomputing is always correct, so one invalid lane means a fresh
        # sweep for every lane ----
        if bool(c.cache_valid.all()):
            zbar, vbar = c.zbar_c, c.vbar_c
            rnorm, nMrz, nMrv = c.rnorm_c, c.nMrz_c, c.nMrv_c
        else:
            zbar, vbar, _Mrz, _Mrv, rnsq, nMrz, nMrv = cp_sweep_metric(
                data, meta, c.z, c.v, gamma, sigma, x0, fused=fused_sweep,
                ops=ops)
            rnorm = torch.sqrt(torch.clamp(rnsq, min=0.0))
        rz = sub(c.z, zbar)
        rv = sub(c.v, vbar)
        r_pair = (rz, rv)

        # ---- quasi-Newton direction ----
        # A lane on the first iteration of a solve (niter == 0: fresh start or
        # farm refill) has no valid previous residual/step: masked on read.
        has_prev = c.niter > 0
        if opts.direction == "anderson":
            y = bwhere(has_prev, (sub(rz, c.r_prev[0]), sub(rv, c.r_prev[1])),
                       r_pair)
            p = bwhere(has_prev, tmap(torch.subtract, c.s_prev, y),
                       tmap(torch.negative, y))
            MR = anderson.hist_insert(c.dirstate[0], y)
            MP = anderson.hist_insert(c.dirstate[1], p)
            dz, dv = anderson.direction_struct(MR, MP, r_pair, c.niter,
                                               ops.gram)
            dirstate = (MR, MP)
        elif opts.direction == "broyden":
            hp = has_prev[:, None]
            r_flat = _ravel_pair(rz, rv)
            y_flat = r_flat - torch.where(hp, _ravel_pair(*c.r_prev), 0.0)
            s_flat = torch.where(hp, _ravel_pair(*c.s_prev), 0.0)
            sz, sv = _unravel_pair(s_flat, c.z, c.v)
            Msz, Msv = metric_pair(data, meta, sz, sv, gamma, sigma,
                                   fused=fused_sweep)
            d_flat, dirstate = broyden.direction(
                c.dirstate, r_flat, s_flat, y_flat, _ravel_pair(Msz, Msv),
                opts.broyden_mem)
            dz, dv = _unravel_pair(d_flat, c.z, c.v)
        else:  # plain residual direction (KM step candidates)
            dz, dv = tmap(torch.negative, rz), tmap(torch.negative, rv)
            dirstate = ()

        # ---- CP fallback ----
        if opts.lam == 1.0:
            z_fb, v_fb = zbar, vbar
        else:
            z_fb = lincomb(opts.lam, zbar, 1.0 - opts.lam, c.z)
            v_fb = lincomb(opts.lam, vbar, 1.0 - opts.lam, c.v)
        # operator-free termination residuals of the fallback step
        xi1_fb = opts.lam * nMrz / gamma
        xi2_fb = opts.lam * nMrv / sigma

        # ---- K0 blind update (off by default) ----
        if opts.k0:
            k0_mask = rnorm <= opts.c0 * c.eta
            eta_new = torch.where(k0_mask, rnorm, c.eta)
            z_init = bwhere(k0_mask, tmap(torch.add, c.z, dz), z_fb)
            v_init = bwhere(k0_mask, tmap(torch.add, c.v, dv), v_fb)
            # K0 lanes report the fixed-point residual scale, not ||M d||:
            # a degenerate direction must not read as convergence
            xi1_init = torch.where(k0_mask, nMrz / gamma, xi1_fb)
            xi2_init = torch.where(k0_mask, nMrv / sigma, xi2_fb)
            loop_init = ~k0_mask
        else:
            eta_new = c.eta
            z_init, v_init = z_fb, v_fb
            xi1_init, xi2_init = xi1_fb, xi2_fb
            loop_init = torch.ones((B,), dtype=torch.bool, device=device)

        # r_safe decay q^k on the per-lane iteration counter
        q_pow = torch.pow(torch.tensor(opts.q, dtype=dtype, device=device),
                          c.niter.to(dtype))

        candidate = _make_candidate(data, meta, x0, c.z, c.v, dz, dv, rnorm,
                                    q_pow, opts, gamma, sigma, fused_sweep,
                                    ops)

        # ---- first trial at tau = 1 (the common accept path) ----
        looping0 = loop_init & (~c.done)
        (z_a, v_a, r_safe_a, xi1_a, xi2_a, looping1, k1_first), cache = (
            candidate(torch.ones((B,), dtype=dtype, device=device), looping0,
                      z_init, v_init, c.r_safe, xi1_init, xi2_init))

        bt = _run_backtracks(candidate, opts, looping1, z_a, v_a, r_safe_a,
                             xi1_a, xi2_a, dtype)
        z_new, v_new = bt.z_acc, bt.v_acc

        # ---- termination from the accumulated norms ----
        xi1, xi2 = bt.xi1, bt.xi2
        conv, res0 = check_termination(xi1, xi2, c.res0, tol)
        s_new = (sub(z_new, c.z), sub(v_new, c.v))
        # per-lane cache validity: the lane accepted this exact tau=1
        # candidate, or is/became done (its sweep results are never read)
        cache_valid = k1_first | c.done | conv
        if record:
            _record(c.hist, c.it, xi1, xi2, bt.bt - 1)

        active = ~c.done
        return SPCarry(
            x0=c.x0,
            z=bwhere(active, z_new, c.z),
            v=bwhere(active, v_new, c.v),
            r_prev=bwhere(active, r_pair, c.r_prev),
            s_prev=bwhere(active, s_new, c.s_prev),
            # not lane-masked: a finished lane's direction is never applied
            dirstate=dirstate,
            r_safe=torch.where(active, bt.r_safe, c.r_safe),
            eta=torch.where(active, eta_new, c.eta),
            res0=torch.where(active[:, None], res0, c.res0),
            done=c.done | conv,
            niter=c.niter + active.to(torch.int32),
            xi1=torch.where(active, xi1, c.xi1),
            xi2=torch.where(active, xi2, c.xi2),
            it=c.it + 1,
            cache_valid=cache_valid,
            zbar_c=cache[0],
            vbar_c=cache[1],
            rnorm_c=cache[2],
            nMrz_c=cache[3],
            nMrv_c=cache[4],
            hist=c.hist,
        )

    return body


# ---------------------------------------------------------------------------
# The fused step: one sp_step_fused launch and one sp_step_backtrack launch
# per iteration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SPCarryF:
    """Carry of the fused step.  The Anderson window is three row pairs in
    phase slots: the row written at iteration t lives in slot t mod 3, so a
    row that only ages passes through untouched and no history is copied.
    There is no ``eta``: K0 is off on this path."""

    x0: Any  # [B, nx]
    z: Primal
    v: Dual
    cache: Any  # (Primal, Dual): the last tau=1 candidate's sweep
    r_prev: Any  # (Primal, Dual)
    s_prev: Any  # (Primal, Dual)
    MR: Any  # 3 (Primal, Dual) pairs: y rows by phase slot
    MP: Any  # 3 (Primal, Dual) pairs: p rows by phase slot
    r_safe: Any  # [B]
    res0: Any  # [B, 2]
    done: Any  # [B] bool
    niter: Any  # [B] int32
    xi1: Any  # [B]
    xi2: Any  # [B]
    it: int  # iterations run on this carry; the phase is it mod 3
    cache_valid: Any  # [B] bool: per lane, the cache is the sweep at (z, v)
    rnorm_c: Any  # [B] the cache's ||r||_M and inf-norms of M r
    nMrz_c: Any
    nMrv_c: Any
    hist: Any = None  # [max_iter + 2, B, 3] trace with record=True, else None


def root_u_carry(sp):
    """Root input u_1 from either carry flavor (read by the MPC farm)."""
    return sp.z.u[:, :, 0]


def use_fused_step(data: ProblemData, meta: ProblemMeta, opts: SuperMannOpts,
                   fused_sweep: bool = True, fused_step: bool = True,
                   constrain=None) -> bool:
    """The fused step covers the production configuration: Anderson window 3,
    no K0, the fused sweep, no ``constrain`` hook, and a problem class the
    kernels cover."""
    return (fused_step and fused_sweep and constrain is None
            and opts.direction == "anderson"
            and not opts.k0 and opts.aa_window == 3
            and spstep.supported(meta, data))


def sp_init_fused(meta: ProblemMeta, x0, z0: Primal, v0: Dual,
                  opts: SuperMannOpts = SuperMannOpts(), max_iter: int = 1000,
                  record: bool = False) -> SPCarryF:
    """The initial fused-step carry for a batch of lanes (with ``record``,
    a zero [max_iter + 2, B, 3] trace: the JAX package's 3-phase loop may
    run two iterations past max_iter)."""
    B = x0.shape[0]
    dtype, device = x0.dtype, x0.device

    def full(value, dt=dtype):
        return torch.full((B,), value, dtype=dt, device=device)

    zpair = (tmap(torch.zeros_like, z0), tmap(torch.zeros_like, v0))
    return SPCarryF(
        x0=x0, z=z0, v=v0, cache=zpair, r_prev=zpair, s_prev=zpair,
        MR=(zpair,) * 3, MP=(zpair,) * 3,
        r_safe=full(float("inf")),
        res0=torch.full((B, 2), float("-inf"), dtype=dtype, device=device),
        done=full(False, torch.bool),
        niter=full(0, torch.int32),
        xi1=full(float("inf")),
        xi2=full(float("inf")),
        it=0,
        cache_valid=full(False, torch.bool),
        rnorm_c=full(0.0), nMrz_c=full(0.0), nMrv_c=full(0.0),
        hist=(torch.zeros((max_iter + 2, B, 3), dtype=dtype, device=device)
              if record else None),
    )


def step_inputs(c: SPCarryF, opts: SuperMannOpts, phase: int, act, cache,
                r_safe, tau, q=None) -> tuple:
    """The arguments of ``spstep.sp_step_fused`` from ``z`` to the scalar
    pack, for a launch at history phase ``phase`` with the per-lane flags
    ``act``, ``cache`` and values ``r_safe``, ``tau``; ``q``: opts.q as a
    0-d tensor of the carry's type and device (made here if None: a copy
    from the host, which a CUDA graph capture does not allow)."""
    dtype, device = c.r_safe.dtype, c.r_safe.device
    m = opts.aa_window
    a1, a2 = (phase - 1) % m, (phase - 2) % m
    if q is None:
        q = torch.tensor(opts.q, dtype=dtype, device=device)
    q_pow = torch.pow(q, c.niter.to(dtype))
    scal = torch.stack(
        [act.to(dtype), (c.niter >= 1).to(dtype), (c.niter >= 2).to(dtype),
         cache.to(dtype), r_safe, q_pow, c.rnorm_c, c.nMrz_c, c.nMrv_c, tau],
        dim=-1)
    return (c.z, c.v, c.cache, c.r_prev, c.s_prev, c.MR[a1], c.MR[a2],
            c.MP[a1], c.MP[a2], c.x0, scal)


def sp_body_fused(data: ProblemData, meta: ProblemMeta, tol,
                  opts: SuperMannOpts, phase: int, gamma=None, sigma=None,
                  record: bool = False):
    """One fused SuperMann iteration at history phase ``phase`` (= it mod
    3): carry -> carry, one sp_step_fused launch at tau = 1 and one
    sp_step_backtrack launch, with no host sync.  The MR/MP slots of phase
    - 1 and phase - 2 are the rows of age 1 and 2; the new rows go to slot
    ``phase``.  With ``record`` the carry's trace gets the iteration's row,
    its rounds the most trials of a lane, taken on the device."""
    if gamma is None or sigma is None:
        gamma = sigma = step_size(data)
    tol = float(tol)
    m = opts.aa_window
    # r_safe decays as q^niter: q on the device once per body
    q = torch.tensor(opts.q, dtype=data.dtype, device=data.device)
    knobs = dict(c1=opts.c1, sigma_k2=opts.sigma_k2, lam=opts.lam,
                 lam_sp=opts.lam_sp)

    def body(c: SPCarryF) -> SPCarryF:
        B = c.done.shape[0]
        dtype, device = c.r_safe.dtype, c.r_safe.device
        active = ~c.done
        ones = torch.ones((B,), dtype=dtype, device=device)
        args = step_inputs(c, opts, phase, active, c.cache_valid, c.r_safe,
                           ones, q)
        z_new, w, r, s, y, p, sc, keep = spstep.sp_step_fused(
            data, meta, *args, gamma, sigma, **knobs)
        # backtracking: each lane still looping tries tau = beta, beta^2,
        # ... on the zbar and d the tau = 1 launch kept (z has not moved),
        # in one launch that writes z_new and s in place at those lanes; a
        # lane's last trial gives its scalars (r_safe and the fallback's
        # residuals unchanged where none accepted)
        sc_bt = spstep.sp_step_backtrack(
            data, meta, c.z, c.v, keep, c.x0, args[-1], sc, z_new, s, gamma,
            sigma, opts.beta, opts.max_backtracks, **knobs)
        r_safe = sc_bt[:, spstep.OC_RSAFE]
        xi1, xi2 = sc_bt[:, spstep.OC_XI1], sc_bt[:, spstep.OC_XI2]
        k1_first = sc[:, spstep.OC_K1] > 0.5

        conv, res0 = check_termination(xi1, xi2, c.res0, tol)
        if record:
            _record(c.hist, c.it, xi1, xi2, sc_bt[:, spstep.OC_TRIALS].max())
        return SPCarryF(
            x0=c.x0,
            z=z_new[0],
            v=z_new[1],
            cache=w,
            r_prev=r,
            s_prev=s,
            MR=tuple(y if j == phase else c.MR[j] for j in range(m)),
            MP=tuple(p if j == phase else c.MP[j] for j in range(m)),
            r_safe=torch.where(active, r_safe, c.r_safe),
            res0=torch.where(active[:, None], res0, c.res0),
            done=c.done | (conv & active),
            niter=c.niter + active.to(torch.int32),
            xi1=torch.where(active, xi1, c.xi1),
            xi2=torch.where(active, xi2, c.xi2),
            it=c.it + 1,
            cache_valid=k1_first | c.done | conv,
            # the tau=1 candidate's ||r~|| is the next ||r|| when cached
            rnorm_c=sc[:, spstep.OC_RT],
            nMrz_c=sc[:, spstep.OC_NMRWZ],
            nMrv_c=sc[:, spstep.OC_NMRWV],
            hist=c.hist,
        )

    return body


def run_supermann(data: ProblemData, meta: ProblemMeta, x0, z0: Primal,
                  v0: Dual, tol, max_iter: int,
                  opts: SuperMannOpts = SuperMannOpts(), gamma=None,
                  sigma=None, fused_sweep: bool = True,
                  fused_step: bool = True,
                  record: bool = False, constrain=None) -> SolveResult:
    """Solve to tolerance from a warm start (z0, v0); batched [B, ...].
    ``record``: the per-iteration trace in ``result.residuals``.
    ``constrain``: a ``tree -> tree`` hook on (z, v) every iteration (then
    never the fused step)."""
    if use_fused_step(data, meta, opts, fused_sweep, fused_step, constrain):
        c = sp_init_fused(meta, x0, z0, v0, opts, max_iter, record)
        bodies = [sp_body_fused(data, meta, tol, opts, phase=ph, gamma=gamma,
                                sigma=sigma, record=record)
                  for ph in range(3)]
    else:
        c = sp_init(meta, x0, z0, v0, opts, max_iter, record)
        bodies = [sp_body(data, meta, tol, opts, gamma=gamma, sigma=sigma,
                          fused_sweep=fused_sweep, record=record,
                          constrain=constrain)]
    while c.it < max_iter:
        with profiling.span("spock.sp.sync"):
            done = bool(c.done.all())
        if done:
            break
        with profiling.span("spock.sp.iter"):
            c = bodies[c.it % len(bodies)](c)
    return SolveResult(
        z=c.z,
        v=c.v,
        iterations=c.niter,
        status=torch.where(c.done, 0, 1).to(torch.int32),
        xi1=c.xi1,
        xi2=c.xi2,
        residuals=c.hist,
    )
