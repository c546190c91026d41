"""The discretized car model (same spec as ``spock_tpu/models/car.py``):
nx = 2, nu = 1, two dynamics realizations.
"""

from __future__ import annotations

import numpy as np

from .. import problem, risks
from ..tree import UniformTree


def make_spec(N: int = 3, d: int = 2, alpha: float = 0.95) -> problem.Spec:
    nx, nu = 2, 1
    tree = UniformTree(N=N, d=d)
    Ts = 0.1
    # A_i = [[1, Ts], [0, 1 - (i-1)/d * Ts]]
    A = np.stack(
        [np.array([[1.0, Ts], [0.0, 1.0 - i / d * Ts]]) for i in range(d)]
    )
    B = np.stack([np.array([[0.0], [Ts]]) for _ in range(d)])

    cost = problem.Cost(
        Q=np.array([[2.2, 0.0], [0.0, 3.7]])[None],
        R=np.array([[3.2]])[None],
        QN=np.array([[2.2, 0.0], [0.0, 3.7]])[None],
    )

    p = np.array([0.3, 0.7]) if d == 2 else np.ones(d) / d
    risk = risks.avar(p, alpha, tree.n_nonleaf)
    constraints = problem.Box(x_min=-1.0, x_max=1.0, u_min=-1.0, u_max=1.0)
    return problem.Spec(
        tree=tree,
        cost=cost,
        dynamics=problem.Dynamics(A=A, B=B),
        risk=risk,
        constraints=constraints,
    )
