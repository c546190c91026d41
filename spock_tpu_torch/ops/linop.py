"""The linear operator L, its adjoint, and the SuperMann metric M.

Feature-major, stage-major, sibling-major layout (node axis last, see
:mod:`spock_tpu_torch.tree`):

* parent -> children replication is a per-stage concat of d contiguous
  copies of the parent block;
* children -> parent reduction is a per-stage contiguous [d, m] reshape and
  a sum over the sibling axis;
* per-node matrix applications contract the small feature axis (-2), with a
  size-1 node dim for uniform problem data.

Everything accepts arbitrary leading batch dims.
"""

from __future__ import annotations

import numpy as np
import torch

from ..problem import ProblemData, ProblemMeta
from ..zv import Dual, Primal, tmap, vdot


def nmul(M, x):
    """Apply per-node matrices: M [K, a, b] (K in {1, n}), x [..., b, n] -> [..., a, n].

    Per node, the product is a broadcast multiply and a sum over a node-last
    copy of M: for ~1e3 matrices of 20 x 20 that is about twice as fast on
    the CPU as a batched product (``einsum``)."""
    if M.shape[0] == 1:
        return torch.matmul(M[0], x)
    return (M.permute(1, 2, 0).contiguous() * x.unsqueeze(-3)).sum(-2)


def nmul_t(M, x):
    """Adjoint application: M [K, a, b], x [..., a, n] -> [..., b, n]."""
    if M.shape[0] == 1:
        return torch.matmul(M[0].transpose(0, 1), x)
    return (M.permute(2, 1, 0).contiguous() * x.unsqueeze(-3)).sum(-2)


def rep_children(a, tree):
    """[..., n_nonleaf] -> [..., n - 1]: each parent's value replicated to its
    children, in the sibling-major non-root order.  ``tree``: the layout
    (:mod:`spock_tpu_torch.tree`)."""
    parts = []
    for t in range(tree.N - 1):
        parts.extend(tree.scatter(t + 1, [a[..., tree.stage_slice(t)]]
                                  * tree.d))
    return torch.cat(parts, dim=-1)


def sum_children(arrs, tree):
    """[..., n - 1] (non-root order) -> [..., n_nonleaf] for each of the
    arrays ``arrs``: sum each parent's d children (a contiguous [d, m]
    reshape per stage, the arrays' stages gathered together)."""
    d = tree.d
    outs = [[] for _ in arrs]
    for t in range(1, tree.N):
        m = tree.stage_size(t - 1)
        lo = tree.stage_offset(t) - 1
        blks = tree.gather(t, [a[..., lo: lo + tree.stage_size(t)]
                               for a in arrs])
        for out, blk in zip(outs, blks):
            out.append(blk.reshape(blk.shape[:-1] + (d, m)).sum(dim=-2))
    return [torch.cat(out, dim=-1) for out in outs]


def bdot(b, y):
    """b [K, ny] (K in {1, n}), y [..., ny, n] -> [..., n]."""
    if b.shape[0] == 1:
        return torch.einsum("y,...yn->...n", b[0], y)
    return torch.einsum("ny,...yn->...n", b, y)


def apply_L(data: ProblemData, meta: ProblemMeta, z: Primal) -> Dual:
    """v = L z."""
    t = meta.tree
    n_nl, ls = t.n_nonleaf, t.leaf_start

    x_nl = z.x[..., :n_nl]
    x_leaf = z.x[..., ls:]
    x_par = rep_children(x_nl, t)  # [..., nx, n-1]
    u_par = rep_children(z.u, t)  # [..., nu, n-1]

    half_tau = 0.5 * z.tau
    half_s_leaf = 0.5 * z.s[..., ls:]

    pnl = plf = None
    if meta.nc_nl > 0:
        pnl = (torch.einsum("cx,...xn->...cn", data.Gx, x_nl)
               + torch.einsum("cu,...un->...cn", data.Gu, z.u))
    if meta.nc_lf > 0:
        plf = torch.einsum("cx,...xn->...cn", data.GxN, x_leaf)

    return Dual(
        y=z.y,
        sby=z.s[..., :n_nl] - bdot(data.b, z.y),
        qx=nmul(data.sqrtQ, x_par),
        ru=nmul(data.sqrtR, u_par),
        t5=half_tau,
        t6=half_tau,
        cx=x_nl,
        cu=z.u,
        qNx=nmul(data.sqrtQN, x_leaf),
        s12=half_s_leaf,
        s13=half_s_leaf,
        cxN=x_leaf,
        pnl=pnl,
        plf=plf,
    )


def apply_LT(data: ProblemData, meta: ProblemMeta, v: Dual) -> Primal:
    """z = L' v."""
    t = meta.tree

    cq, cr = sum_children([nmul_t(data.sqrtQ, v.qx),
                           nmul_t(data.sqrtR, v.ru)], t)
    x_nl = v.cx + cq
    x_leaf = v.cxN + nmul_t(data.sqrtQN, v.qNx)
    u = v.cu + cr

    if v.pnl is not None:
        x_nl = x_nl + torch.einsum("cx,...cn->...xn", data.Gx, v.pnl)
        u = u + torch.einsum("cu,...cn->...un", data.Gu, v.pnl)
    if v.plf is not None:
        x_leaf = x_leaf + torch.einsum("cx,...cn->...xn", data.GxN, v.plf)

    if data.b.shape[0] == 1:
        y = v.y - data.b[0][:, None] * v.sby[..., None, :]
    else:
        y = v.y - data.b.transpose(-1, -2) * v.sby[..., None, :]

    s = torch.cat([v.sby, 0.5 * (v.s12 + v.s13)], dim=-1)
    return Primal(
        x=torch.cat([x_nl, x_leaf], dim=-1),
        u=u,
        s=s,
        tau=0.5 * (v.t5 + v.t6),
        y=y,
    )


def metric_apply(data, meta, z: Primal, v: Dual, gamma, sigma):
    """M (z, v) = (z - gamma L'v, v - sigma L z); the plain version of
    :func:`spock_tpu_torch.ops.sweep_kernels.metric_apply_fused`."""
    Ltv = apply_LT(data, meta, v)
    Lz = apply_L(data, meta, z)
    mz = tmap(lambda a, b: a - gamma * b, z, Ltv)
    mv = tmap(lambda a, b: a - sigma * b, v, Lz)
    return mz, mv


def spock_dot(data, meta, az, av, bz, bv, gamma, sigma, batch_ndim: int = 0):
    """<(az, av), M (bz, bv)>: one L and one L' application."""
    mz, mv = metric_apply(data, meta, bz, bv, gamma, sigma)
    return vdot(az, mz, batch_ndim) + vdot(av, mv, batch_ndim)


def estimate_L_sq(data: ProblemData, meta: ProblemMeta, iters: int = 50,
                  rng=None) -> float:
    """Power iteration on L'L in the data's dtype and device; returns a
    slightly inflated ||L||^2 so that gamma = sigma = 0.99 / ||L|| satisfy
    gamma * sigma * ||L||^2 < 1.  The start vector is drawn from ``rng``
    (default ``np.random.default_rng(0)``) in the JAX package's order."""
    rng = rng or np.random.default_rng(0)
    t = meta.tree

    def rnd(shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=data.dtype,
                               device=data.device)

    z = Primal(
        x=rnd((meta.nx, t.n)),
        u=rnd((meta.nu, t.n_nonleaf)),
        s=rnd((t.n,)),
        tau=rnd((t.n - 1,)),
        y=rnd((meta.ny, t.n_nonleaf)),
    )
    lam = None
    for _ in range(iters):
        w = apply_LT(data, meta, apply_L(data, meta, z))
        lam = vdot(w, z) / torch.clamp(vdot(z, z), min=1e-30)
        nrm = torch.sqrt(torch.clamp(vdot(w, w), min=1e-30))
        z = tmap(lambda a: a / nrm, w)
    return float(lam) * 1.02
