"""Online dynamics projection (S1) by stage-batched Riccati sweeps.

The exact Euclidean projection of a stacked (x, u) onto the affine subspace
{x_root = x0, x_j = A_wj x_i + B_wj u_i}.  Each stage is one batched tensor
op over all d^t nodes of the stage, and the N-stage backward/forward
recursions are unrolled in Python.  The k-th children of the stage-t nodes
are the contiguous block ``[k*m, (k+1)*m)`` of stage t+1 (sibling-major).
The offline factors are stage-uniform (node dim 1).  The tree is
``meta.tree``'s layout (:mod:`spock_tpu_torch.tree`): the costates cross
into a stage's parents through its ``gather``, the rollout into a stage
through its ``scatter``.
"""

from __future__ import annotations

import torch

from ..problem import ProblemData, ProblemMeta


def project_dynamics(data: ProblemData, meta: ProblemMeta, x, u, x0):
    """Project (x, u) onto the dynamics subspace; returns (x_proj, u_proj).

    x: [..., nx, n] (targets), u: [..., nu, n_nonleaf], x0: [..., nx].
    """
    t = meta.tree
    N, d = t.N, t.d
    ric = data.ric
    B = data.B  # [d, nx, nu]
    Bt = B.transpose(-1, -2)

    # ---- backward sweep: costate q and feedforward dvec ----
    q_next = -x[..., t.stage_offset(N - 1):]  # [..., nx, m_leaf]
    dvecs = [None] * (N - 1)
    for st in range(N - 2, -1, -1):
        sl = t.stage_slice(st)
        Rt = ric.Rtinv[st][0]  # [nu, nu]
        Kt = ric.K[st][0]  # [nu, nx]
        ABKt = ric.ABK[st][0]  # [d, nx, nx]
        PBt = ric.PB[st][0]  # [d, nx, nu]
        (q_next,) = t.gather(st + 1, [q_next])
        m = t.stage_size(st)
        qks = [q_next[..., k * m:(k + 1) * m] for k in range(d)]
        sum_d = None
        for k in range(d):
            term = torch.matmul(Bt[k], qks[k])
            sum_d = term if sum_d is None else sum_d + term
        u_st = u[..., sl]
        dvec = torch.matmul(Rt, u_st - sum_d)
        dvecs[st] = dvec
        # q_i = sum_k ABK_k' (P_k B_k d_i + q_k) + K' (d_i - u_i) - x_i
        qi = None
        for k in range(d):
            inner = torch.matmul(PBt[k], dvec) + qks[k]
            term = torch.matmul(ABKt[k].transpose(0, 1), inner)
            qi = term if qi is None else qi + term
        qi = qi + torch.matmul(Kt.transpose(0, 1), dvec - u_st)
        q_next = qi - x[..., sl]

    # ---- forward sweep: x_root = x0, closed-loop rollout ----
    x_st = x0[..., None]  # [..., nx, 1]
    xs = [x_st]
    us = []
    for st in range(N - 1):
        Kt = ric.K[st][0]
        ABKt = ric.ABK[st][0]
        u_st = torch.matmul(Kt, x_st) + dvecs[st]
        us.append(u_st)
        x_st = torch.cat(t.scatter(st + 1, [
            torch.matmul(ABKt[k], x_st) + torch.matmul(B[k], dvecs[st])
            for k in range(d)]), dim=-1)
        xs.append(x_st)

    return torch.cat(xs, dim=-1), torch.cat(us, dim=-1)
