"""The server_heat problem family in plain numpy: a frozen copy of the model.

spock.jl's ``examples/server_heat`` (the reference's own experiment): nx = nu
servers, each heated by its own input and coupled to its neighbours; d
realizations of the dynamics on a uniform scenario tree of N stages;
stage cost x'Qx + u'Ru with Q = 0.1 I, R = I, terminal x'QN x with QN = 0.1 I;
AV@R_alpha over the children of every non-leaf node; boxes
-1 <= x <= 1, -1.5 <= u <= 1.5 at every node.  Realization i (0-based) has

    A_i = diag(1 + (1 + j/nx) * i/d) + 0.01 on the first off-diagonals,
    B_i = I.

Written from that description, independently of the program: it imports
nothing of it.
"""

from __future__ import annotations

import numpy as np


def make(config: dict) -> dict:
    """The problem's arrays in float64 from a configuration's ``shape``."""
    shape = config["shape"]
    N, nx, d = int(shape["N"]), int(shape["nx"]), int(shape["d"])
    nu = nx
    A = np.zeros((d, nx, nx))
    for i in range(d):
        A[i] = np.diag([1.0 + (1.0 + j / nx) * i / d for j in range(nx)])
        for k in range(nx - 1):
            A[i, k, k + 1] = A[i, k + 1, k] = 0.01
    B = np.broadcast_to(np.eye(nx), (d, nx, nu)).copy()
    p = np.asarray(shape["p"], dtype=np.float64)
    if p.shape != (d,) or abs(p.sum() - 1.0) > 1e-12:
        raise ValueError(f"p={p} is not a probability vector of size {d}")
    return dict(
        N=N, d=d, nx=nx, nu=nu, A=A, B=B,
        Q=0.1 * np.eye(nx), R=np.eye(nu), QN=0.1 * np.eye(nx),
        p=p, alpha=float(shape["alpha"]),
        x_lo=-1.0, x_hi=1.0, u_lo=-1.5, u_hi=1.5,
    )
