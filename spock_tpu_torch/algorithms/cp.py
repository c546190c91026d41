"""Plain Chambolle-Pock iteration (CPOCK), lane-masked over the batch.

Default step sizes sigma = gamma = 0.99 / ||L|| from the build's
power-iteration estimate.  The JAX package's ``lax.while_loop`` is a host
loop here.
"""

from __future__ import annotations

import torch

from ..problem import ProblemData, ProblemMeta, step_size
from ..zv import Dual, Primal, lincomb, sub
from .common import (
    SolveResult,
    bwhere,
    check_termination,
    cp_sweep,
    residual_norms,
)


def run_cp(data: ProblemData, meta: ProblemMeta, x0, z0: Primal, v0: Dual,
           tol, max_iter: int, gamma=None, sigma=None,
           lam: float = 1.0, fused_sweep: bool = True,
           record: bool = False) -> SolveResult:
    """Solve to tolerance from a warm start (z0, v0); everything batched
    [B, ...], x0: [B, nx].  ``fused_sweep``: one kernel launch per sweep
    where the sweep kernel covers the problem (default), the composed path
    when False.  ``record``: keep every iteration's (xi1, xi2), every lane's
    whether active or not, in ``result.residuals`` [max_iter, B, 2] (rows
    after the last iteration stay zero)."""
    if gamma is None or sigma is None:
        gamma = sigma = step_size(data)
    tol = float(tol)
    B = x0.shape[0]
    dtype, device = x0.dtype, x0.device

    z, v = z0, v0
    res0 = torch.full((B, 2), float("-inf"), dtype=dtype, device=device)
    done = torch.zeros((B,), dtype=torch.bool, device=device)
    niter = torch.zeros((B,), dtype=torch.int32, device=device)
    xi1 = torch.full((B,), float("inf"), dtype=dtype, device=device)
    xi2 = torch.full((B,), float("inf"), dtype=dtype, device=device)
    hist = (torch.zeros((max_iter, B, 2), dtype=dtype, device=device)
            if record else None)
    it = 0
    while it < max_iter and not bool(done.all()):
        zbar, vbar = cp_sweep(data, meta, z, v, gamma, sigma, x0,
                              fused=fused_sweep)
        if lam == 1.0:
            z_new, v_new = zbar, vbar
        else:
            z_new = lincomb(lam, zbar, 1.0 - lam, z)
            v_new = lincomb(lam, vbar, 1.0 - lam, v)
        x1, x2 = residual_norms(data, meta, sub(z_new, z), sub(v_new, v),
                                gamma, sigma)
        conv, res0_new = check_termination(x1, x2, res0, tol)
        active = ~done
        if record:
            hist[it] = torch.stack([x1, x2], dim=-1)
        z = bwhere(active, z_new, z)
        v = bwhere(active, v_new, v)
        res0 = torch.where(active[:, None], res0_new, res0)
        done = done | conv
        niter = niter + active.to(torch.int32)
        xi1 = torch.where(active, x1, xi1)
        xi2 = torch.where(active, x2, xi2)
        it += 1
    return SolveResult(
        z=z, v=v, iterations=niter,
        status=torch.where(done, 0, 1).to(torch.int32), xi1=xi1, xi2=xi2,
        residuals=hist,
    )
