"""Conic risk measures (numpy, host side).

A coherent risk measure at a non-leaf node is given by matrices
``(E, F, b)`` and a cone ``K`` such that the dual variable ``y`` of the
risk epigraph satisfies

    y in K*,    b' y <= s_i,    E' y = tau_child + s_child,    F' y = 0.

Cones are described statically (tuples of ``(kind, dim)``) while the
numeric data ``(E, F, b)`` are stacked per node.  Same constructions as
``spock_tpu/risks.py``; the exponential cone (EVaR) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# A cone product is a tuple of (kind, dim) pairs over contiguous segments of
# the y vector. kind in {"zero", "nonneg", "nonpos", "reals", "soc"}.
ConeSpec = Tuple[Tuple[str, int], ...]

_DUALS = {
    "zero": "reals",
    "reals": "zero",
    "nonneg": "nonneg",
    "nonpos": "nonpos",
    "soc": "soc",
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


def rand_probvec(rng: np.random.Generator, d: int) -> np.ndarray:
    """Random probability vector."""
    v = rng.random(d)
    return v / v.sum()
