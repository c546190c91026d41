"""The two proximal operators of the splitting.

prox_f  — shift s_root by -gamma, project (x, u) onto the dynamics subspace
          (S1, Riccati) and (s_{1:}, tau, y) onto the risk-epigraph kernels
          (S2).
prox_h* — Moreau-decomposed projection onto the translated product set S3
          (SOCs for the cost epigraphs, dual risk cones, nonnegativity,
          boxes).  :func:`prox_h_conj` is also the plain version of the CUDA
          kernel in :mod:`spock_tpu_torch.ops.cuda_kernels`.
"""

from __future__ import annotations

import dataclasses

import torch

from ..problem import ProblemData, ProblemMeta
from ..zv import Dual, Primal, tmap
from .cones import project_box, project_cone_product, project_soc
from .linop import nmul
from .riccati import project_dynamics


def project_risk_kernel(data: ProblemData, meta: ProblemMeta, s_rest, tau, y):
    """S2: per non-leaf node, project (y_i, s_children, tau_children) onto
    ker([E' -I -I; F' 0 0]) with the precomputed orthogonal projector.

    s_rest: [..., n-1] (s over non-root nodes), tau: [..., n-1],
    y: [..., ny, n_nonleaf].  Each stage's non-root block reshapes
    contiguously to [d, m], the sibling index becoming a feature dim (on a
    layout that splits the stage, gathered whole first and scattered back
    after: see :mod:`spock_tpu_torch.tree`).
    """
    t = meta.tree
    d = t.d

    def to_children_fm(a, b):
        # [..., n-1] -> [..., d, n_nonleaf], for a and b (each stage of
        # both gathered together)
        parts = ([], [])
        for st in range(1, t.N):
            m = t.stage_size(st - 1)
            lo = t.stage_offset(st) - 1
            blks = t.gather(st, [a[..., None, lo: lo + t.stage_size(st)],
                                 b[..., None, lo: lo + t.stage_size(st)]])
            for out, blk in zip(parts, blks):
                out.append(blk[..., 0, :].reshape(blk.shape[:-2] + (d, m)))
        return [torch.cat(out, dim=-1) for out in parts]

    def from_children_fm(block):
        # inverse of to_children_fm: [..., d, n_nonleaf] -> [..., n-1]
        parts = []
        off = 0
        for st in range(1, t.N):
            m = t.stage_size(st - 1)
            blk = block[..., :, off: off + m]
            parts.extend(t.scatter(st, [blk.reshape(blk.shape[:-2]
                                                    + (d * m,))]))
            off += m
        return torch.cat(parts, dim=-1)

    vec = torch.cat([y, *to_children_fm(s_rest, tau)], dim=-2)
    out = nmul(data.ker_proj, vec)
    y_p = out[..., : meta.ny, :]
    s_p = from_children_fm(out[..., meta.ny: meta.ny + d, :])
    t_p = from_children_fm(out[..., meta.ny + d:, :])
    return s_p, t_p, y_p


def prox_f(data: ProblemData, meta: ProblemMeta, z: Primal, gamma, x0) -> Primal:
    """z <- prox_{gamma f}(z), f(z) = s_root + indicator(S1 x S2).
    s_root itself is only shifted, not projected."""
    s0 = z.s[..., :1] - gamma
    x_p, u_p = project_dynamics(data, meta, z.x, z.u, x0)
    s_rest, tau_p, y_p = project_risk_kernel(data, meta, z.s[..., 1:], z.tau,
                                             z.y)
    return Primal(x=x_p, u=u_p, s=torch.cat([s0, s_rest], dim=-1), tau=tau_p,
                  y=y_p)


def _project_S3(data: ProblemData, meta: ProblemMeta, w: Dual) -> Dual:
    """Projection onto the product set S3.  SOC vectors are ordered (t, x)."""
    # non-root stage-cost SOCs: (t6, qx, ru, t5) per non-root node
    nl_p = project_soc(torch.cat(
        [w.t6[..., None, :], w.qx, w.ru, w.t5[..., None, :]], dim=-2))
    # leaf terminal-cost SOCs: (s13, qNx, s12) per leaf node
    leaf_p = project_soc(torch.cat(
        [w.s13[..., None, :], w.qNx, w.s12[..., None, :]], dim=-2))
    nx, nu = meta.nx, meta.nu
    return Dual(
        y=project_cone_product(w.y, meta.dual_cone),
        sby=torch.clamp(w.sby, min=0.0),
        qx=nl_p[..., 1: 1 + nx, :],
        ru=nl_p[..., 1 + nx: 1 + nx + nu, :],
        t5=nl_p[..., -1, :],
        t6=nl_p[..., 0, :],
        cx=project_box(w.cx, data.x_min, data.x_max),
        cu=project_box(w.cu, data.u_min, data.u_max),
        qNx=leaf_p[..., 1: 1 + nx, :],
        s12=leaf_p[..., -1, :],
        s13=leaf_p[..., 0, :],
        cxN=project_box(w.cxN, data.x_min, data.x_max),
        pnl=None if w.pnl is None else project_box(w.pnl, data.p_lo, data.p_hi),
        plf=None if w.plf is None else project_box(w.plf, data.pN_lo,
                                                   data.pN_hi),
    )


def prox_h_conj(data: ProblemData, meta: ProblemMeta, v: Dual, sigma) -> Dual:
    """v <- prox_{sigma h*}(v) by Moreau: sigma * (w - proj_S3(w)), where w
    is v/sigma with the +-1/2 epigraph shifts on (t5, t6, s12, s13)."""
    inv = 1.0 / sigma
    w = tmap(lambda a: a * inv, v)
    w = dataclasses.replace(w, t5=w.t5 - 0.5, t6=w.t6 + 0.5,
                            s12=w.s12 - 0.5, s13=w.s13 + 0.5)
    p = _project_S3(data, meta, w)
    return tmap(lambda a, b: sigma * (a - b), w, p)
