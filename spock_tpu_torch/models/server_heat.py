"""The server_heat benchmark problem family (same spec as
``spock_tpu/models/server_heat.py``): nx == nu servers with coupled heating dynamics,
Q = 0.1 I, R = I, QN = 0.1 I, AV@R(alpha) risk, box constraints
x in [-1, 1], u in [-1.5, 1.5].
"""

from __future__ import annotations

import numpy as np

from .. import problem, risks
from ..tree import UniformTree


def make_spec(
    N: int,
    nx: int,
    d: int,
    alpha: float = 0.95,
    rng: np.random.Generator | None = None,
) -> problem.Spec:
    nu = nx
    tree = UniformTree(N=N, d=d)

    # Dynamics: per realization i (1-based),
    # A_i = diag(1 + (1 + (j-1)/nx) * (i-1)/d) with 0.01 on the off-diagonals,
    # B_i = I.
    A = np.zeros((d, nx, nx))
    for i in range(d):
        diag = np.array([1.0 + (1.0 + j / nx) * i / d for j in range(nx)])
        A[i] = np.diag(diag)
        f = 0.01
        for k in range(nx - 1):
            A[i][k, k + 1] = f
            A[i][k + 1, k] = f
    B = np.broadcast_to(np.eye(nx), (d, nx, nu)).copy()

    cost = problem.Cost(
        Q=0.1 * np.eye(nx)[None],
        R=1.0 * np.eye(nu)[None],
        QN=0.1 * np.eye(nx)[None],
    )

    # Probabilities: [0.3, 0.7] for d = 2, random otherwise.
    if d == 2:
        p = np.array([0.3, 0.7])
    else:
        p = risks.rand_probvec(rng or np.random.default_rng(0), d)
    risk = risks.avar(p, alpha, tree.n_nonleaf)

    constraints = problem.Box(x_min=-1.0, x_max=1.0, u_min=-1.5, u_max=1.5)

    return problem.Spec(
        tree=tree,
        cost=cost,
        dynamics=problem.Dynamics(A=A, B=B),
        risk=risk,
        constraints=constraints,
    )
