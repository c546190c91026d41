"""Plain PyTorch reference of risk-averse MPC on a uniform scenario tree.

The problem: from a root state x0, choose u at every non-leaf node to

    minimise  V_0,   V_i = x_i'Q x_i + u_i'R u_i + AV@R_alpha(V_children),
                     V_leaf = x'QN x,
    subject to x_j = A_k x_i + B_k u_i   (j the k-th child of i),
               boxes on x (every node but the root) and u.

AV@R_alpha over the children with probabilities p is the largest expectation
over the measures mu with sum(mu) = 1, 0 <= mu <= p/alpha.  So the problem is
the saddle point of sum_i pi_i c_i(x_i, u_i) over the node weights pi, the
products of those measures along each path.  Solved here by alternation:
for the weights pi, a box-constrained LQ problem on the tree, solved by a
primal-dual interior-point method whose Newton systems are tree Riccati
recursions; for the solution, the weights that attain the nested AV@R
(greedy, node by node); until the weights repeat.  A repeat is a saddle
point, hence the optimum.

Nodes are stage-major and, within stage t + 1, sibling-major: the k-th child
of the stage-t node i sits at stage-local index k * d**t + i.  Everything
carries a leading axis of S independent problems.  Imports nothing of the
program.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Problem:
    """The model's arrays as tensors of one dtype and device."""

    N: int
    d: int
    nx: int
    nu: int
    A: torch.Tensor  # [d, nx, nx]
    B: torch.Tensor  # [d, nx, nu]
    Q: torch.Tensor
    R: torch.Tensor
    QN: torch.Tensor
    p: torch.Tensor  # [d]
    alpha: float
    x_lo: float
    x_hi: float
    u_lo: float
    u_hi: float
    # products in TF32: every operand rounded to 10 mantissa bits, as the
    # tensor cores do (the control's precision; float32 storage)
    tf32: bool = False

    @classmethod
    def of(cls, model: dict, dtype=torch.float64, device="cpu",
           tf32: bool = False):
        def t(a):
            return torch.as_tensor(a, dtype=dtype, device=device)

        return cls(N=model["N"], d=model["d"], nx=model["nx"],
                   nu=model["nu"], A=t(model["A"]), B=t(model["B"]),
                   Q=t(model["Q"]), R=t(model["R"]), QN=t(model["QN"]),
                   p=t(model["p"]), alpha=model["alpha"],
                   x_lo=model["x_lo"], x_hi=model["x_hi"],
                   u_lo=model["u_lo"], u_hi=model["u_hi"], tf32=tf32)


def _round_tf32(t):
    """float32 values rounded to the nearest with 10 mantissa bits."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(P: Problem, a, b):
    if P.tf32:
        return _round_tf32(a) @ _round_tf32(b)
    return a @ b


def _mv(P: Problem, M, v):
    return _mm(P, M, v.unsqueeze(-1)).squeeze(-1)


def children(P: Problem, a, b=None):
    """The children's values of a stage: [S, d * n, nx] from the parents'
    x (``a``) and u (``b``), [S, n, .]."""
    S, n = a.shape[:2]
    out = _mv(P, P.A[None, :, None], a[:, None])
    if b is not None:
        out = out + _mv(P, P.B[None, :, None], b[:, None])
    return out.reshape(S, P.d * n, -1)


def rollout(P: Problem, x0, us):
    """States of every stage from x0 [S, nx] and the inputs of every
    non-leaf stage (a list of [S, d**t, nu])."""
    xs = [x0[:, None]]
    for t in range(P.N - 1):
        xs.append(children(P, xs[t], us[t]))
    return xs


def _quad(P: Problem, M, v):
    return (v * _mv(P, M, v)).sum(-1)


def node_costs(P: Problem, xs, us):
    """c_i per stage: x'Qx + u'Ru at non-leaf nodes, x'QN x at leaves."""
    out = [_quad(P, P.Q, xs[t]) + _quad(P, P.R, us[t])
           for t in range(P.N - 1)]
    return out + [_quad(P, P.QN, xs[-1])]


def _greedy(P: Problem, vals):
    """The AV@R measure of each parent attaining the largest expectation of
    its children's values ``vals`` [S, d, n]: fill the caps p/alpha in
    decreasing order of value.  Returns mu [S, d, n]."""
    order = torch.argsort(vals, dim=1, descending=True, stable=True)
    cap = torch.clamp(P.p / P.alpha, max=1.0)[order]  # [S, d, n]
    before = torch.cumsum(cap, dim=1) - cap
    mu_sorted = torch.clamp(torch.minimum(cap, 1.0 - before), min=0.0)
    return torch.zeros_like(mu_sorted).scatter(1, order, mu_sorted)


def nested_values(P: Problem, costs):
    """(V per stage, mu per non-leaf stage [S, d, n]) of the nested AV@R of
    the node costs."""
    V = [None] * P.N
    mus = [None] * (P.N - 1)
    V[-1] = costs[-1]
    for t in range(P.N - 2, -1, -1):
        S, n = costs[t].shape
        ch = V[t + 1].reshape(S, P.d, n)
        mus[t] = _greedy(P, ch)
        V[t] = costs[t] + (mus[t] * ch).sum(1)
    return V, mus


def weights(P: Problem, mus):
    """Node weights pi per stage from the per-parent measures."""
    S = mus[0].shape[0]
    pi = [torch.ones((S, 1), dtype=mus[0].dtype, device=mus[0].device)]
    for t in range(P.N - 1):
        pi.append((mus[t] * pi[t][:, None]).reshape(S, -1))
    return pi


def _lq_solve(P: Problem, Hx, Hu, gx, gu):
    """Newton direction of the box-constrained LQ problem: minimise
    sum 1/2 dx'Hx dx + gx'dx + 1/2 du'Hu du + gu'du over the tree with
    homogeneous dynamics and dx_0 = 0.  Hx[t]: [S, n, nx, nx] for t >= 1
    (None at the root), Hu[t]: [S, n, nu, nu]; by Riccati recursion."""
    N, d = P.N, P.d
    A = P.A[None, :, None]  # [1, d, 1, nx, nx]
    B = P.B[None, :, None]
    At, Bt = A.transpose(-1, -2), B.transpose(-1, -2)
    Pm, pv = Hx[N - 1], gx[N - 1]
    K, k = [None] * (N - 1), [None] * (N - 1)
    for t in range(N - 2, -1, -1):
        S, n = gu[t].shape[:2]
        Pc = Pm.reshape(S, d, n, P.nx, P.nx)
        pc = pv.reshape(S, d, n, P.nx)
        PB, PA = _mm(P, Pc, B), _mm(P, Pc, A)
        Huu = Hu[t] + _mm(P, Bt, PB).sum(1)
        Hux = _mm(P, Bt, PA).sum(1)
        hu = gu[t] + _mv(P, Bt, pc).sum(1)
        L = torch.linalg.cholesky(0.5 * (Huu + Huu.transpose(-1, -2)))
        K[t] = -torch.cholesky_solve(Hux, L)
        k[t] = -torch.cholesky_solve(hu.unsqueeze(-1), L).squeeze(-1)
        if t > 0:
            Pm = (Hx[t] + _mm(P, At, PA).sum(1)
                  + _mm(P, Hux.transpose(-1, -2), K[t]))
            Pm = 0.5 * (Pm + Pm.transpose(-1, -2))
            pv = (gx[t] + _mv(P, At, pc).sum(1)
                  + _mv(P, Hux.transpose(-1, -2), k[t]))
    S = gu[0].shape[0]
    dx = [torch.zeros((S, 1, P.nx), dtype=gu[0].dtype, device=gu[0].device)]
    du = []
    for t in range(N - 1):
        du.append(_mv(P, K[t], dx[t]) + k[t])
        dx.append(children(P, dx[t], du[t]))
    return dx, du


def _diag(v):
    return torch.diag_embed(v)


def solve_lq(P: Problem, x0, pi, us=None, mu_stop=1e-13, max_iter=200):
    """Primal-dual interior point for the box-constrained LQ problem with
    node weights ``pi``: the iterate keeps the dynamics (a rollout), the
    bound slacks start feasible and the residuals of the bounds close.
    Returns (xs, us, iterations, converged)."""
    N = P.N
    if us is None:
        # a start inside the input box that keeps the states small
        G = torch.linalg.pinv(P.B.mean(0)) @ P.A.mean(0)
        us, xs = [], [x0[:, None]]
        for t in range(N - 1):
            u = -_mv(P, G, xs[t])
            us.append(torch.clamp(u, 0.9 * P.u_lo, 0.9 * P.u_hi))
            xs.append(children(P, xs[t], us[t]))
    xs = rollout(P, x0, us)
    # the bounded variables: x of stages 1..N-1, u of stages 0..N-2
    V = xs[1:] + us
    lo = [P.x_lo] * (N - 1) + [P.u_lo] * (N - 1)
    hi = [P.x_hi] * (N - 1) + [P.u_hi] * (N - 1)
    slo = [torch.clamp(v - l, min=1.0) for v, l in zip(V, lo)]
    shi = [torch.clamp(h - v, min=1.0) for v, h in zip(V, hi)]
    llo = [torch.ones_like(v) for v in V]
    lhi = [torch.ones_like(v) for v in V]
    nvar = sum(v.numel() for v in V) * 2
    sigma = 0.1
    it, converged = 0, False
    for it in range(1, max_iter + 1):
        mu = (sum((a * b).sum() for a, b in zip(llo, slo))
              + sum((a * b).sum() for a, b in zip(lhi, shi))) / nvar
        r1 = [v - l - s for v, l, s in zip(V, lo, slo)]
        r2 = [h - v - s for v, h, s in zip(V, hi, shi)]
        # gradient of the weighted costs, Hessian, barrier terms
        grad, hess = [], []
        for t in range(1, N):
            M = P.QN if t == N - 1 else P.Q
            w = 2.0 * pi[t][..., None]
            grad.append(w * _mv(P, M, xs[t]))
            hess.append(w[..., None] * M)
        for t in range(N - 1):
            w = 2.0 * pi[t][..., None]
            grad.append(w * _mv(P, P.R, us[t]))
            hess.append(w[..., None] * P.R)
        g, H = [], []
        for j in range(len(V)):
            D = llo[j] / slo[j] + lhi[j] / shi[j]
            H.append(hess[j] + _diag(D))
            g.append(grad[j] - sigma * mu / slo[j] + llo[j] * r1[j] / slo[j]
                     + sigma * mu / shi[j] - lhi[j] * r2[j] / shi[j])
        try:
            dx, du = _lq_solve(P, [None] + H[:N - 1], H[N - 1:],
                               [None] + g[:N - 1], g[N - 1:])
        except torch.linalg.LinAlgError:
            break  # the Newton system lost definiteness in low precision
        dV = dx[1:] + du
        dslo = [a + r for a, r in zip(dV, r1)]
        dshi = [-a + r for a, r in zip(dV, r2)]
        dllo = [(sigma * mu - l * s - l * ds) / s
                for l, s, ds in zip(llo, slo, dslo)]
        dlhi = [(sigma * mu - l * s - l * ds) / s
                for l, s, ds in zip(lhi, shi, dshi)]
        step = torch.ones((), dtype=x0.dtype, device=x0.device)
        for a, da in zip(slo + shi + llo + lhi, dslo + dshi + dllo + dlhi):
            neg = da < 0
            if bool(neg.any()):
                step = torch.minimum(step, (-a[neg] / da[neg]).min())
        step = torch.clamp(0.99 * step, max=1.0)
        us = [u + step * d_ for u, d_ in zip(us, du)]
        xs = [x + step * d_ for x, d_ in zip(xs, dx)]
        V = xs[1:] + us
        slo = [a + step * d_ for a, d_ in zip(slo, dslo)]
        shi = [a + step * d_ for a, d_ in zip(shi, dshi)]
        llo = [a + step * d_ for a, d_ in zip(llo, dllo)]
        lhi = [a + step * d_ for a, d_ in zip(lhi, dlhi)]
        infeas = max(float(r.abs().max()) for r in r1 + r2)
        dmax = max(float(d_.abs().max()) for d_ in dV)
        if float(mu) < mu_stop and infeas < 1e-9 and dmax * float(step) < 1e-9:
            converged = True
            break
    return xs, us, it, converged


@dataclasses.dataclass
class Solution:
    u0: torch.Tensor  # [S, nu] the root input
    value: torch.Tensor  # [S] V_0, the nested risk of the optimal costs
    xs: list
    us: list
    outer: int  # weight updates made
    newton: int  # interior-point iterations, in all
    converged: bool


def solve(P: Problem, x0, max_outer=12, mu_stop=1e-13, max_iter=200):
    """The optimum from the root states x0 [S, nx]."""
    x0 = torch.as_tensor(x0, dtype=P.A.dtype, device=P.A.device)
    S = x0.shape[0]
    # start from the nominal measure p at every parent
    mus = [P.p[None, :, None].expand(S, P.d, P.d ** t).clone()
           for t in range(P.N - 1)]
    us, newton, ok = None, 0, True
    for outer in range(1, max_outer + 1):
        xs, us, it, conv = solve_lq(P, x0, weights(P, mus), us,
                                    mu_stop=mu_stop, max_iter=max_iter)
        newton += it
        ok = ok and conv
        V, new = nested_values(P, node_costs(P, xs, us))
        if all(torch.equal(a, b) for a, b in zip(mus, new)):
            return Solution(u0=us[0][:, 0], value=V[0][:, 0], xs=xs, us=us,
                            outer=outer, newton=newton, converged=ok)
        mus = new
    return Solution(u0=us[0][:, 0], value=V[0][:, 0], xs=xs, us=us,
                    outer=max_outer, newton=newton, converged=False)


def plant(P: Problem, x, u, w):
    """x+ = A[w] x + B[w] u, per row: x [M, nx], u [M, nu], w [M]."""
    return _mv(P, P.A[w], x) + _mv(P, P.B[w], u)
