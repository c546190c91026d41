"""Conic risk measures (numpy, host side).

A coherent risk measure at a non-leaf node is given by matrices
``(E, F, b)`` and a cone ``K`` such that the dual variable ``y`` of the
risk epigraph satisfies

    y in K*,    b' y <= s_i,    E' y = tau_child + s_child,    F' y = 0.

Cones are described statically (tuples of ``(kind, dim)``) while the
numeric data ``(E, F, b)`` are stacked per node.  Same constructions as
``spock_tpu/risks.py``, EVaR's exponential cone included.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# A cone product is a tuple of (kind, dim) pairs over contiguous segments of
# the y vector. kind in {"zero", "nonneg", "nonpos", "reals", "soc", "exp"}.
ConeSpec = Tuple[Tuple[str, int], ...]

_DUALS = {
    "zero": "reals",
    "reals": "zero",
    "nonneg": "nonneg",
    "nonpos": "nonpos",
    "soc": "soc",
    # the exponential cone's dual, projected by Moreau in ops.cones
    "exp": "exp_dual",
    "exp_dual": "exp",
}


def dual_cone(spec: ConeSpec) -> ConeSpec:
    """Dual of a product cone (product of duals)."""
    return tuple((_DUALS[k], dim) for k, dim in spec)


def cone_dim(spec: ConeSpec) -> int:
    return sum(dim for _, dim in spec)


@dataclasses.dataclass(frozen=True)
class RiskSpec:
    """Static description and numeric data of the per-node risk measures.

    Attributes:
      E: [n_nonleaf, ny, d] ambiguity-set matrix.
      F: [n_nonleaf, ny, nf] equality-coupling matrix.
      b: [n_nonleaf, ny] support vector.
      cone: product-cone spec of K (y must lie in K*, the dual).
      kind/params: the named risk family, where there is one (EVaR:
        ``("evar", (p, alpha))``), which the scipy oracle solves in its
        own smooth form.
    """

    E: np.ndarray
    F: np.ndarray
    b: np.ndarray
    cone: ConeSpec
    kind: str = "generic"
    params: tuple = ()

    @property
    def ny(self) -> int:
        return self.b.shape[-1]

    @property
    def n_nonleaf(self) -> int:
        return self.b.shape[0]


def _uniform(E, F, b, cone, n_nonleaf) -> RiskSpec:
    return RiskSpec(
        E=np.broadcast_to(E, (n_nonleaf,) + E.shape).copy(),
        F=np.broadcast_to(F, (n_nonleaf,) + F.shape).copy(),
        b=np.broadcast_to(b, (n_nonleaf,) + b.shape).copy(),
        cone=cone,
    )


def avar(p: np.ndarray, alpha: float, n_nonleaf: int) -> RiskSpec:
    """Uniform AV@R_alpha risk over all non-leaf nodes:

      E = [alpha*I_d; -I_d; 1_d'],  F = 0 (2d+1 x d),  b = [p; 0_d; 1],
      K = Nonneg(2d) x Zero(1).
    """
    p = np.asarray(p, dtype=np.float64)
    d = p.shape[0]
    E = np.concatenate([alpha * np.eye(d), -np.eye(d), np.ones((1, d))], axis=0)
    F = np.zeros((2 * d + 1, d))
    b = np.concatenate([p, np.zeros(d), np.ones(1)])
    return _uniform(E, F, b, (("nonneg", 2 * d), ("zero", 1)), n_nonleaf)


def avar_nonuniform(ps: np.ndarray, alphas: np.ndarray) -> RiskSpec:
    """Per-node AV@R with node-dependent probabilities and levels: the
    matrices of :func:`avar` stacked per node.  ps: [n_nonleaf, d], alphas:
    [n_nonleaf]."""
    ps = np.asarray(ps, dtype=np.float64)
    alphas = np.asarray(alphas, dtype=np.float64)
    n_nonleaf, d = ps.shape
    eye = np.eye(d)
    E = np.concatenate([alphas[:, None, None] * eye[None],
                        -np.broadcast_to(eye, (n_nonleaf, d, d)),
                        np.ones((n_nonleaf, 1, d))], axis=1)
    F = np.zeros((n_nonleaf, 2 * d + 1, d))
    b = np.concatenate([ps, np.zeros((n_nonleaf, d)),
                        np.ones((n_nonleaf, 1))], axis=1)
    return RiskSpec(E=E, F=F, b=b, cone=(("nonneg", 2 * d), ("zero", 1)))


def total_variation(p: np.ndarray, r: float, n_nonleaf: int) -> RiskSpec:
    """Uniform total-variation risk:

      E = [I/2; -I/2; 0],  F = [-I; -I; I],  b = [p/2; -p/2; r*1_d],
      K = Nonneg(3d).
    """
    p = np.asarray(p, dtype=np.float64)
    d = p.shape[0]
    eye = np.eye(d)
    E = np.concatenate([0.5 * eye, -0.5 * eye, np.zeros((d, d))], axis=0)
    F = np.concatenate([-eye, -eye, eye], axis=0)
    b = np.concatenate([0.5 * p, -0.5 * p, r * np.ones(d)])
    return _uniform(E, F, b, (("nonneg", 3 * d),), n_nonleaf)


def risk_neutral(p: np.ndarray, n_nonleaf: int) -> RiskSpec:
    """Risk-neutral expectation, encoded as AV@R with alpha = 1."""
    return avar(p, 1.0, n_nonleaf)


def evar(p: np.ndarray, alpha: float, n_nonleaf: int) -> RiskSpec:
    """Uniform entropic value-at-risk, EVaR_alpha(X) = max{mu'X :
    KL(mu || p) <= -ln alpha}, a KL ball written with exponential cones in
    the form  A = {mu : exists nu, b - E mu - F nu in K}:

      rows 0..d-1 :  mu_k                in R+          (mu >= 0)
      row  d      :  1 - 1'mu            in {0}         (sum to one)
      row  d+1    :  r - 1'nu            in R+          (KL budget, r = -ln a)
      rows d+2..  :  (-nu_k, mu_k, p_k)  in K_exp       (mu_k ln(mu_k/p_k)
                                                         <= nu_k), per k.

    ny = 4d + 2, nf = d auxiliary variables nu.
    """
    p = np.asarray(p, dtype=np.float64)
    d = p.shape[0]
    r = -float(np.log(alpha))
    ny = 4 * d + 2
    E = np.zeros((ny, d))
    F = np.zeros((ny, d))
    b = np.zeros(ny)
    E[:d, :] = -np.eye(d)
    E[d, :] = 1.0
    b[d] = 1.0
    F[d + 1, :] = 1.0
    b[d + 1] = r
    for k in range(d):
        row = d + 2 + 3 * k
        F[row, k] = 1.0  # x: -nu_k = b - F nu
        E[row + 1, k] = -1.0  # y: mu_k
        b[row + 2] = p[k]  # z: p_k
    cone: ConeSpec = (("nonneg", d), ("zero", 1), ("nonneg", 1)) + tuple(
        ("exp", 3) for _ in range(d))
    return dataclasses.replace(_uniform(E, F, b, cone, n_nonleaf),
                               kind="evar", params=(tuple(p.tolist()), alpha))


def rand_probvec(rng: np.random.Generator, d: int) -> np.ndarray:
    """Random probability vector."""
    v = rng.random(d)
    return v / v.sum()
