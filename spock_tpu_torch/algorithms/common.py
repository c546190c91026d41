"""Shared pieces of the iterative algorithms (CP and SuperMann).

Batch convention: every iterate carries exactly one leading lane axis
[B, ...]; per-lane scalars (norms, flags, counters) have shape [B].
Lane-masked updates give exact per-lane termination: a converged lane's
iterate is frozen while the others go on.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from ..ops import cuda_kernels, sweep_kernels
from ..ops.linop import apply_L, apply_LT, metric_apply
from ..ops.prox import prox_f, prox_h_conj
from ..zv import Dual, Primal, inf_norm, lincomb, sub, tmap, vdot


def bexpand(a, ref):
    """Broadcast a [B]-shaped per-lane scalar against a [B, ...] leaf."""
    return a.reshape(a.shape + (1,) * (ref.ndim - a.ndim))


def bwhere(mask, new, old):
    """Lane-masked select over a tree."""
    return tmap(lambda n, o: torch.where(bexpand(mask, n), n, o), new, old)


def blincomb(a, x, b, y):
    """Per-lane linear combination a*x + b*y (a, b: [B])."""
    return tmap(lambda xl, yl: bexpand(a, xl) * xl + bexpand(b, yl) * yl, x, y)


def _cp_sweep_composed(data, meta, z, v, gamma, sigma, x0, prox_h):
    z1 = tmap(lambda a, b: a - gamma * b, z, apply_LT(data, meta, v))
    zbar = prox_f(data, meta, z1, gamma, x0)
    z_refl = lincomb(2.0, zbar, -1.0, z)
    v1 = tmap(lambda a, b: a + sigma * b, v, apply_L(data, meta, z_refl))
    return zbar, prox_h(v1)


def cp_sweep_ref(data, meta, z: Primal, v: Dual, gamma, sigma, x0):
    """The CP sweep in plain PyTorch operators, no kernel anywhere: the plain
    version of the sweep kernels (``ops.sweep_kernels``)."""
    return _cp_sweep_composed(data, meta, z, v, gamma, sigma, x0,
                              lambda v1: prox_h_conj(data, meta, v1, sigma))


def cp_sweep(data, meta, z: Primal, v: Dual, gamma, sigma, x0,
             fused: bool = True):
    """One Chambolle-Pock sweep: returns (zbar, vbar).

    zbar = prox_f(z - gamma L' v); vbar = prox_h*(v + sigma L (2 zbar - z)).
    With ``fused`` and a problem the sweep kernel covers, the sweep is one
    kernel launch.  Otherwise it is the composed path: PyTorch operators,
    with the prox_h* phase in its own kernel where that kernel covers the
    problem.  (A wrapper itself takes its plain version for CPU tensors.)
    """
    if fused and sweep_kernels.supported(meta, data):
        return sweep_kernels.cp_sweep_fused(data, meta, z, v, gamma, sigma, x0)
    if cuda_kernels.supported(meta):
        def prox_h(v1):
            return cuda_kernels.prox_h_conj_fused(data, meta, v1, sigma)
    else:
        def prox_h(v1):
            return prox_h_conj(data, meta, v1, sigma)
    return _cp_sweep_composed(data, meta, z, v, gamma, sigma, x0, prox_h)


def _sweep_metric_tail(data, meta, z, v, zbar, vbar, gamma, sigma):
    rz, rv = sub(z, zbar), sub(v, vbar)
    Mrz, Mrv = metric_apply(data, meta, rz, rv, gamma, sigma)
    rnorm_sq = vdot(rz, Mrz, 1) + vdot(rv, Mrv, 1)
    return (zbar, vbar, Mrz, Mrv, rnorm_sq,
            inf_norm(Mrz, batch_ndim=1), inf_norm(Mrv, batch_ndim=1))


def cp_sweep_metric(data, meta, z: Primal, v: Dual, gamma, sigma, x0,
                    fused: bool = True):
    """One CP sweep plus the metric image of its fixed-point residual and the
    per-lane reductions SuperMann consumes: returns ``(zbar, vbar, Mrz, Mrv,
    rnorm_sq, nMrz, nMrv)`` with ``(Mrz, Mrv) = M (z - zbar, v - vbar)``,
    ``rnorm_sq = <r, M r>`` and nMrz/nMrv the inf-norms of M r's halves.
    One kernel launch with ``fused`` where the sweep kernel covers the
    problem."""
    if fused and sweep_kernels.supported(meta, data):
        return sweep_kernels.cp_sweep_metric_fused(data, meta, z, v, gamma,
                                                   sigma, x0)
    zbar, vbar = cp_sweep(data, meta, z, v, gamma, sigma, x0, fused=False)
    return _sweep_metric_tail(data, meta, z, v, zbar, vbar, gamma, sigma)


def cp_sweep_metric_ref(data, meta, z: Primal, v: Dual, gamma, sigma, x0):
    """Plain-operator :func:`cp_sweep_metric` (see :func:`cp_sweep_ref`)."""
    zbar, vbar = cp_sweep_ref(data, meta, z, v, gamma, sigma, x0)
    return _sweep_metric_tail(data, meta, z, v, zbar, vbar, gamma, sigma)


def _candidate_sweep_tail(data, meta, z, v, dz, dv, tau, gamma, sigma, x0, Md,
                          sweep):
    tau = torch.as_tensor(tau, dtype=z.s.dtype, device=z.s.device)
    w = tmap(lambda a, b: a + bexpand(tau, a) * b, z, dz)
    u = tmap(lambda a, b: a + bexpand(tau, a) * b, v, dv)
    wbar, ubar = sweep(data, meta, w, u, gamma, sigma, x0)
    rw, ru = sub(w, wbar), sub(u, ubar)
    Mrz, Mrv = metric_apply(data, meta, rw, ru, gamma, sigma)
    rnorm_sq = vdot(rw, Mrz, 1) + vdot(ru, Mrv, 1)
    Mdz, Mdv = Md if Md is not None else metric_apply(
        data, meta, dz, dv, gamma, sigma)
    rho_dot = vdot(rw, Mdz, 1) + vdot(ru, Mdv, 1)
    return (
        wbar, ubar, Mrz, Mrv, rnorm_sq,
        inf_norm(Mrz, batch_ndim=1), inf_norm(Mrv, batch_ndim=1),
        rho_dot,
        inf_norm(Mdz, batch_ndim=1), inf_norm(Mdv, batch_ndim=1),
    )


def candidate_sweep(data, meta, z: Primal, v: Dual, dz: Primal, dv: Dual, tau,
                    gamma, sigma, x0, Md=None, fused: bool = True):
    """SuperMann candidate evaluation at (w, u) = (z, v) + tau (dz, dv).

    Returns ``(wbar, ubar, Mrz, Mrv, rnorm_sq, nMrz, nMrv, rho_dot, nMdz,
    nMdv)``: the first seven as :func:`cp_sweep_metric` at the candidate,
    plus ``rho_dot = <r~, M d>`` and the inf-norms of M d's halves.  One
    kernel launch with ``fused`` where the sweep kernel covers the problem (M
    d is never stored there).  On the composed path ``Md`` may carry a
    precomputed ``(Mdz, Mdv)``: d does not change between backtracking
    trials, so the caller computes it once."""
    if fused and sweep_kernels.supported(meta, data):
        return sweep_kernels.candidate_sweep_fused(data, meta, z, v, dz, dv,
                                                   tau, gamma, sigma, x0)

    return _candidate_sweep_tail(data, meta, z, v, dz, dv, tau, gamma, sigma,
                                 x0, Md, functools.partial(cp_sweep,
                                                           fused=False))


def candidate_sweep_ref(data, meta, z, v, dz, dv, tau, gamma, sigma, x0,
                        Md=None):
    """Plain-operator :func:`candidate_sweep` (see :func:`cp_sweep_ref`)."""
    return _candidate_sweep_tail(data, meta, z, v, dz, dv, tau, gamma, sigma,
                                 x0, Md, cp_sweep_ref)


def metric_pair(data, meta, z: Primal, v: Dual, gamma, sigma,
                fused: bool = True):
    """M (z, v): one kernel launch with ``fused`` where the sweep kernels
    cover the problem, the plain operators otherwise."""
    if fused and sweep_kernels.supported(meta, data):
        return sweep_kernels.metric_apply_fused(data, meta, z, v, gamma, sigma)
    return metric_apply(data, meta, z, v, gamma, sigma)


def residual_norms(data, meta, dz: Primal, dv: Dual, gamma, sigma):
    """Per-lane termination residuals

      xi1 = || L' dv - dz / gamma ||_inf,  xi2 = || L dz - dv / sigma ||_inf.
    """
    xi1 = tmap(lambda a, b: a - b / gamma, apply_LT(data, meta, dv), dz)
    xi2 = tmap(lambda a, b: a - b / sigma, apply_L(data, meta, dz), dv)
    return inf_norm(xi1, batch_ndim=1), inf_norm(xi2, batch_ndim=1)


def check_termination(xi1, xi2, res0, tol):
    """Relative-to-first-residual criterion.  Returns (converged [B],
    updated res0 [B, 2]).  On a lane's first iteration res0 is -inf, so the
    check is the absolute tolerance."""
    conv = ((xi1 <= torch.clamp(tol * res0[:, 0], min=tol))
            & (xi2 <= torch.clamp(tol * res0[:, 1], min=tol)))
    xi = torch.stack([xi1, xi2], dim=-1)
    res0_new = torch.where(torch.isneginf(res0), xi, res0)
    return conv, res0_new


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """Outcome of a batched solve: per-lane status 0 = converged,
    1 = hit max_iter."""

    z: Primal
    v: Dual
    iterations: Any  # [B] int32
    status: Any  # [B] int32
    xi1: Any  # [B] final residuals
    xi2: Any  # [B]
    # with record=True: the per-iteration trace, [max_iter, B, 2] (xi1, xi2)
    # from run_cp, [max_iter (+ 2 fused), B, 3] (xi1, xi2, backtracking
    # rounds) from run_supermann
    residuals: Any = None

    @property
    def converged(self):
        return self.status == 0
