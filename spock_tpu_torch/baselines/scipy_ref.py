"""Independent CPU reference solver (correctness oracle), on the port's own
``Spec``.

It solves the same conic program as the splitting solver,

    min s_root
    s.t.  x_root = x0
          x_j = A_wj x_parent(j) + B_wj u_parent(j)          (non-root j)
          x, u in box
          x_i' Q_j x_i + u_i' R_j u_i <= tau_j,  i = parent(j)
          x_i' QN x_i <= s_i                                  (leaves)
          y_i in K*,  b'y_i <= s_i,  E'y_i = tau_child + s_child,  F'y_i = 0

directly with scipy's SLSQP on the dense variable stack: a code path
independent of the splitting solver, usable as a parity oracle for small
trees.  numpy and scipy only; the same method as the JAX package's
``baselines/scipy_ref.py``.
"""

from __future__ import annotations

import numpy as np
from scipy import optimize

from ..problem import Spec
from ..risks import dual_cone
from ..tree import UniformTree


def solve(spec: Spec, x0, tol: float = 1e-10, maxiter: int = 2000):
    """Returns dict with x [n, nx], u [n_nonleaf, nu], s [n], tau [n-1],
    y [n_nonleaf, ny], objective value s[0].

    EVaR risks are solved via their direct smooth epigraph
    (t log-sum-exp form) rather than exponential-cone duals — a genuinely
    independent code path from the splitting solver's cone projections.
    """
    if spec.risk.kind == "evar":
        return _solve_evar(spec, x0, tol=tol, maxiter=maxiter)
    t: UniformTree = spec.tree
    A = np.asarray(spec.dynamics.A, float)
    B = np.asarray(spec.dynamics.B, float)
    nx, nu = A.shape[-1], B.shape[-1]
    n, n_nl, n_lf = t.n, t.n_nonleaf, t.n_leaf

    def nodemat(M, i):
        return M[0] if M.shape[0] == 1 else M[i]

    Q, R, QN = (
        np.asarray(spec.cost.Q, float),
        np.asarray(spec.cost.R, float),
        np.asarray(spec.cost.QN, float),
    )
    E, F, b = (
        np.asarray(spec.risk.E, float),
        np.asarray(spec.risk.F, float),
        np.asarray(spec.risk.b, float),
    )
    ny = b.shape[-1]
    x0 = np.asarray(x0, float)

    # variable stacking: [x (n*nx), u (n_nl*nu), s (n), tau (n-1), y (n_nl*ny)]
    ox, ou = 0, n * nx
    os_, ot = ou + n_nl * nu, ou + n_nl * nu + n
    oy = ot + (n - 1)
    nvar = oy + n_nl * ny

    ix = lambda i: slice(ox + i * nx, ox + (i + 1) * nx)
    iu = lambda i: slice(ou + i * nu, ou + (i + 1) * nu)
    iy = lambda i: slice(oy + i * ny, oy + (i + 1) * ny)

    def split(zf):
        return (
            zf[ox:ou].reshape(n, nx),
            zf[ou:os_].reshape(n_nl, nu),
            zf[os_:ot],
            zf[ot:oy],
            zf[oy:].reshape(n_nl, ny),
        )

    eqs, ineqs = [], []

    # dynamics + root pin
    def eq_dyn(zf):
        x, u, s, tau, y = split(zf)
        out = [x[0] - x0]
        for j in range(1, n):
            i, w = t.parent(j), t.w(j)
            out.append(x[j] - A[w] @ x[i] - B[w] @ u[i])
        return np.concatenate(out)

    eqs.append(eq_dyn)

    # risk equalities: E'y = tau_child + s_child, F'y = 0.
    # Skip identically-zero rows of F' (e.g. AV@R has F == 0): they would be
    # trivially satisfied but make SLSQP's equality Jacobian singular.
    def eq_risk(zf):
        x, u, s, tau, y = split(zf)
        out = []
        for i in range(n_nl):
            Ei, Fi = nodemat(E, i), nodemat(F, i)
            kids = list(t.children(i))
            rhs = np.array([tau[j - 1] + s[j] for j in kids])
            out.append(Ei.T @ y[i] - rhs)
            keep = np.abs(Fi).sum(axis=0) > 0
            if keep.any():
                out.append((Fi.T @ y[i])[keep])
        return np.concatenate(out)

    eqs.append(eq_risk)

    # cost epigraphs (quadratic, smooth)
    def ineq_cost(zf):
        x, u, s, tau, y = split(zf)
        out = []
        for j in range(1, n):
            i = t.parent(j)
            Qj, Rj = nodemat(Q, j - 1), nodemat(R, j - 1)
            out.append(tau[j - 1] - x[i] @ Qj @ x[i] - u[i] @ Rj @ u[i])
        for k in range(n_lf):
            i = t.leaf_start + k
            QNk = nodemat(QN, k)
            out.append(s[i] - x[i] @ QNk @ x[i])
        return np.array(out)

    ineqs.append(ineq_cost)

    # polytopic rows (extension): lo <= Gx x + Gu u <= hi per non-leaf,
    # loN <= GxN x <= hiN per leaf; skip infinite bounds
    if spec.polytope is not None:
        P = spec.polytope
        Gx, Gu = np.asarray(P.Gx, float), np.asarray(P.Gu, float)
        lo, hi = np.asarray(P.lo, float), np.asarray(P.hi, float)
        GxN = np.asarray(P.GxN, float)
        loN, hiN = np.asarray(P.loN, float), np.asarray(P.hiN, float)

        def ineq_poly(zf):
            x, u, s, tau, y = split(zf)
            out = []
            for i in range(n_nl):
                g = Gx @ x[i] + Gu @ u[i]
                out.append((hi - g)[np.isfinite(hi)])
                out.append((g - lo)[np.isfinite(lo)])
            for k in range(n_lf):
                g = GxN @ x[t.leaf_start + k]
                out.append((hiN - g)[np.isfinite(hiN)])
                out.append((g - loN)[np.isfinite(loN)])
            return np.concatenate(out) if out else np.zeros(0)

        ineqs.append(ineq_poly)

    # b'y <= s_i
    def ineq_sby(zf):
        x, u, s, tau, y = split(zf)
        return np.array(
            [s[i] - nodemat(b, i) @ y[i] for i in range(n_nl)]
        )

    ineqs.append(ineq_sby)

    # y in K*: bounds for polyhedral segments, nonlinear for SOC
    lb = np.full(nvar, -np.inf)
    ub = np.full(nvar, np.inf)
    dual = dual_cone(spec.risk.cone)
    for i in range(n_nl):
        off = oy + i * ny
        seg_off = 0
        for kind, dim in dual:
            sl = slice(off + seg_off, off + seg_off + dim)
            if kind == "nonneg":
                lb[sl] = 0.0
            elif kind == "nonpos":
                ub[sl] = 0.0
            elif kind == "zero":
                lb[sl] = ub[sl] = 0.0
            elif kind == "reals":
                pass
            elif kind == "soc":
                s0, d0 = seg_off, dim

                def ineq_soc(zf, i=i, s0=s0, d0=d0):
                    yseg = zf[oy + i * ny + s0 : oy + i * ny + s0 + d0]
                    return np.array(
                        [yseg[0] - np.linalg.norm(yseg[1:])]
                    )

                ineqs.append(ineq_soc)
            else:
                raise NotImplementedError(kind)
            seg_off += dim

    # box constraints
    xminb = np.broadcast_to(np.asarray(spec.constraints.x_min, float), (nx,))
    xmaxb = np.broadcast_to(np.asarray(spec.constraints.x_max, float), (nx,))
    uminb = np.broadcast_to(np.asarray(spec.constraints.u_min, float), (nu,))
    umaxb = np.broadcast_to(np.asarray(spec.constraints.u_max, float), (nu,))
    for i in range(n):
        lb[ix(i)] = np.maximum(lb[ix(i)], xminb)
        ub[ix(i)] = np.minimum(ub[ix(i)], xmaxb)
    for i in range(n_nl):
        lb[iu(i)] = np.maximum(lb[iu(i)], uminb)
        ub[iu(i)] = np.minimum(ub[iu(i)], umaxb)

    z_init = np.zeros(nvar)
    z_init[ix(0)] = np.clip(x0, lb[ix(0)], ub[ix(0)])

    cons = [{"type": "eq", "fun": f} for f in eqs] + [
        {"type": "ineq", "fun": f} for f in ineqs
    ]
    obj_grad = np.zeros(nvar)
    obj_grad[os_] = 1.0
    res = optimize.minimize(
        lambda zf: zf[os_],
        z_init,
        jac=lambda zf: obj_grad,
        bounds=optimize.Bounds(lb, ub),
        constraints=cons,
        method="SLSQP",
        options={"maxiter": maxiter, "ftol": tol},
    )
    if not res.success:
        raise RuntimeError(f"oracle failed: {res.message}")
    x, u, s, tau, y = split(res.x)
    return {
        "x": x,
        "u": u,
        "s": s,
        "tau": tau,
        "y": y,
        "objective": s[0],
        "scipy_result": res,
    }


def _solve_evar(spec: Spec, x0, tol: float = 1e-10, maxiter: int = 3000):
    """EVaR oracle: per non-leaf node i, the nested risk epigraph is

        EVaR_a(X_child) <= s_i
        <=>  exists t_i > 0:  t_i * log sum_k p_k exp(X_k / t_i)
                               - t_i * log(alpha) <= s_i,

    with X_k = tau_child_k + s_child_k — jointly convex in (X, t_i)
    (perspective of log-sum-exp).  Variables: [x, u, s, tau, t]."""
    t: UniformTree = spec.tree
    A = np.asarray(spec.dynamics.A, float)
    B = np.asarray(spec.dynamics.B, float)
    nx, nu = A.shape[-1], B.shape[-1]
    n, n_nl, n_lf = t.n, t.n_nonleaf, t.n_leaf
    p_vec = np.asarray(spec.risk.params[0], float)
    alpha = float(spec.risk.params[1])
    log_alpha = np.log(alpha)
    x0 = np.asarray(x0, float)

    def nodemat(M, i):
        return M[0] if M.shape[0] == 1 else M[i]

    Q, R, QN = (
        np.asarray(spec.cost.Q, float),
        np.asarray(spec.cost.R, float),
        np.asarray(spec.cost.QN, float),
    )

    ox, ou = 0, n * nx
    os_, ot = ou + n_nl * nu, ou + n_nl * nu + n
    otv = ot + (n - 1)
    nvar = otv + n_nl

    def split(zf):
        return (
            zf[ox:ou].reshape(n, nx),
            zf[ou:os_].reshape(n_nl, nu),
            zf[os_:ot],
            zf[ot:otv],
            zf[otv:],
        )

    def eq_dyn(zf):
        x, u, s, tau, tv = split(zf)
        out = [x[0] - x0]
        for j in range(1, n):
            i, w = t.parent(j), t.w(j)
            out.append(x[j] - A[w] @ x[i] - B[w] @ u[i])
        return np.concatenate(out)

    def ineq_cost(zf):
        x, u, s, tau, tv = split(zf)
        out = []
        for j in range(1, n):
            i = t.parent(j)
            Qj, Rj = nodemat(Q, j - 1), nodemat(R, j - 1)
            out.append(tau[j - 1] - x[i] @ Qj @ x[i] - u[i] @ Rj @ u[i])
        for k in range(n_lf):
            i = t.leaf_start + k
            out.append(s[i] - x[i] @ nodemat(QN, k) @ x[i])
        return np.array(out)

    def ineq_evar(zf):
        x, u, s, tau, tv = split(zf)
        out = []
        for i in range(n_nl):
            ti = max(tv[i], 1e-8)
            kids = list(t.children(i))
            X = np.array([tau[j - 1] + s[j] for j in kids])
            m = np.max(X / ti + np.log(p_vec))
            lse = m + np.log(np.sum(np.exp(X / ti + np.log(p_vec) - m)))
            out.append(s[i] - (ti * lse - ti * log_alpha))
        return np.array(out)

    lb = np.full(nvar, -np.inf)
    ub = np.full(nvar, np.inf)
    xminb = np.broadcast_to(np.asarray(spec.constraints.x_min, float), (nx,))
    xmaxb = np.broadcast_to(np.asarray(spec.constraints.x_max, float), (nx,))
    uminb = np.broadcast_to(np.asarray(spec.constraints.u_min, float), (nu,))
    umaxb = np.broadcast_to(np.asarray(spec.constraints.u_max, float), (nu,))
    for i in range(n):
        lb[ox + i * nx : ox + (i + 1) * nx] = xminb
        ub[ox + i * nx : ox + (i + 1) * nx] = xmaxb
    for i in range(n_nl):
        lb[ou + i * nu : ou + (i + 1) * nu] = uminb
        ub[ou + i * nu : ou + (i + 1) * nu] = umaxb
    lb[otv:] = 1e-6  # t_i > 0

    z_init = np.zeros(nvar)
    z_init[ox : ox + nx] = np.clip(x0, lb[ox : ox + nx], ub[ox : ox + nx])
    z_init[otv:] = 1.0

    obj_grad = np.zeros(nvar)
    obj_grad[os_] = 1.0
    res = optimize.minimize(
        lambda zf: zf[os_],
        z_init,
        jac=lambda zf: obj_grad,
        bounds=optimize.Bounds(lb, ub),
        constraints=[
            {"type": "eq", "fun": eq_dyn},
            {"type": "ineq", "fun": ineq_cost},
            {"type": "ineq", "fun": ineq_evar},
        ],
        method="SLSQP",
        options={"maxiter": maxiter, "ftol": tol},
    )
    if not res.success:
        raise RuntimeError(f"EVaR oracle failed: {res.message}")
    x, u, s, tau, tv = split(res.x)
    return {
        "x": x, "u": u, "s": s, "tau": tau, "t": tv,
        "objective": s[0], "scipy_result": res,
    }
