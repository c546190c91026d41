"""Problem specification and the offline build.

The user-facing spec (:class:`Spec` and its parts) is host-side numpy, the
same as the JAX package's (``spock_tpu/problem.py``).  :func:`build` runs the
offline phase in float64 numpy (Riccati factors for the dynamics projection,
the risk-kernel projectors, matrix square roots of the costs), ships every
array to the chosen device in the chosen dtype, and estimates ||L||^2 there
by power iteration.

Per-node arrays keep a node dimension of size 1 when the data is uniform
across nodes, so the factorization is O(N) matrices instead of O(d^N).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from .risks import ConeSpec, RiskSpec, dual_cone
from .tree import UniformTree


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless told otherwise.

    ``None`` means ``cuda``; without a CUDA device that is an error, never a
    quiet move to the CPU.  Pass ``device="cpu"`` to run on the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


# ---------------------------------------------------------------------------
# User-facing spec (numpy, host side)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Cost:
    """Quadratic stage/terminal costs.

    ``Q[j-1]``, ``R[j-1]`` weight the parent's (x, u) on the edge leading to
    non-root node ``j``; ``QN[i]`` weights leaf ``leaf_start + i``.
    Shapes: Q [n-1 | 1, nx, nx], R [n-1 | 1, nu, nu], QN [n_leaf | 1, nx, nx]
    (a size-1 node dim means uniform over nodes).
    """

    Q: np.ndarray
    R: np.ndarray
    QN: np.ndarray


@dataclasses.dataclass(frozen=True)
class Dynamics:
    """d realizations of x+ = A[w] x + B[w] u.  A: [d, nx, nx], B: [d, nx, nu]."""

    A: np.ndarray
    B: np.ndarray


@dataclasses.dataclass(frozen=True)
class Box:
    """Rectangle constraints on states and inputs at every node: scalars or
    [nx]/[nu] arrays; +-inf for unconstrained dims."""

    x_min: Any
    x_max: Any
    u_min: Any
    u_max: Any


@dataclasses.dataclass(frozen=True)
class Polytope:
    """Two-sided polytopic constraints

        lo <= Gx x_i + Gu u_i <= hi   at every non-leaf node,
        loN <= GxN x_i <= hiN         at every leaf node.

    Shapes: Gx [nc, nx], Gu [nc, nu], lo/hi [nc]; GxN [ncN, nx], loN/hiN [ncN].
    """

    Gx: np.ndarray
    Gu: np.ndarray
    lo: np.ndarray
    hi: np.ndarray
    GxN: np.ndarray
    loN: np.ndarray
    hiN: np.ndarray


@dataclasses.dataclass(frozen=True)
class Spec:
    """Full problem specification (host side)."""

    tree: UniformTree
    cost: Cost
    dynamics: Dynamics
    risk: RiskSpec
    constraints: Box
    polytope: Optional[Polytope] = None


# ---------------------------------------------------------------------------
# Built problem (tensors + static meta)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RiccatiData:
    """Offline factors of the dynamics projection (S1), one entry per stage
    t = 0..N-2 (P over t = 0..N-1); node dim 1 (stage-uniform).

      P[t]:      [1, nx, nx]
      K[t]:      [1, nu, nx]     feedback gains
      Rtinv[t]:  [1, nu, nu]     inverse of I + sum_j B' P_j B
      ABK[t]:    [1, d, nx, nx]  closed-loop A + B K per child edge
      PB[t]:     [1, d, nx, nu]  P_j @ B[w_j] per child edge
    """

    P: Tuple[Any, ...]
    K: Tuple[Any, ...]
    Rtinv: Tuple[Any, ...]
    ABK: Tuple[Any, ...]
    PB: Tuple[Any, ...]


RICCATI_FIELDS = ("P", "K", "Rtinv", "ABK", "PB")


@dataclasses.dataclass(frozen=True)
class ProblemData:
    """All numeric data the solver needs, as tensors on one device."""

    A: Any  # [d, nx, nx]
    B: Any  # [d, nx, nu]
    sqrtQ: Any  # [n-1 | 1, nx, nx]
    sqrtR: Any  # [n-1 | 1, nu, nu]
    sqrtQN: Any  # [n_leaf | 1, nx, nx]
    E: Any  # [n_nonleaf | 1, ny, d]
    F: Any  # [n_nonleaf | 1, ny, nf]
    b: Any  # [n_nonleaf | 1, ny]
    x_min: Any  # [nx]
    x_max: Any
    u_min: Any  # [nu]
    u_max: Any
    ric: RiccatiData
    ker_proj: Any  # [n_nonleaf | 1, ny + 2d, ny + 2d] projector onto ker(M_i)
    L_sq: Any  # 0-d tensor, ||L||^2 estimate
    Gx: Any = None  # [nc, nx]
    Gu: Any = None  # [nc, nu]
    p_lo: Any = None  # [nc]
    p_hi: Any = None
    GxN: Any = None  # [ncN, nx]
    pN_lo: Any = None  # [ncN]
    pN_hi: Any = None

    @property
    def device(self) -> torch.device:
        return self.A.device

    @property
    def dtype(self) -> torch.dtype:
        return self.A.dtype


@dataclasses.dataclass(frozen=True)
class ProblemMeta:
    """Hashable static metadata."""

    tree: UniformTree
    nx: int
    nu: int
    ny: int
    nf: int
    cone: ConeSpec  # K (primal cone of the risk measure)
    nc_nl: int = 0  # polytope rows per non-leaf node (0 = no polytope)
    nc_lf: int = 0  # polytope rows per leaf node

    @property
    def dual_cone(self) -> ConeSpec:
        return dual_cone(self.cone)

    @property
    def nz(self) -> int:
        """Primal dimension."""
        t = self.tree
        return (
            t.n * self.nx
            + t.n_nonleaf * self.nu
            + t.n
            + (t.n - 1)
            + t.n_nonleaf * self.ny
        )

    @property
    def nv(self) -> int:
        """Dual dimension."""
        t = self.tree
        return (
            t.n_nonleaf * self.ny
            + t.n_nonleaf
            + (t.n - 1) * self.nx
            + (t.n - 1) * self.nu
            + 2 * (t.n - 1)
            + t.n_nonleaf * (self.nx + self.nu)
            + t.n_leaf * self.nx
            + 2 * t.n_leaf
            + t.n_leaf * self.nx
            + t.n_nonleaf * self.nc_nl
            + t.n_leaf * self.nc_lf
        )


# ---------------------------------------------------------------------------
# Offline phase (float64 numpy)
# ---------------------------------------------------------------------------


def _sqrtm_psd(M: np.ndarray) -> np.ndarray:
    """Symmetric PSD matrix square root, batched over leading dims."""
    w, V = np.linalg.eigh(M)
    w = np.clip(w, 0.0, None)
    return np.einsum("...ab,...b,...cb->...ac", V, np.sqrt(w), V)


def _riccati_offline(
    tree: UniformTree, A: np.ndarray, B: np.ndarray, uniform: bool
) -> RiccatiData:
    """Backward stage recursion computing the S1 projection factors, with
    identity weights (P = I at the leaves), batched per stage."""
    N, d = tree.N, tree.d
    nx, nu = A.shape[-1], B.shape[-1]
    eye_x, eye_u = np.eye(nx), np.eye(nu)

    P = [None] * N
    K = [None] * (N - 1)
    Rtinv = [None] * (N - 1)
    ABK = [None] * (N - 1)
    PB = [None] * (N - 1)

    m_leaf = 1 if uniform else tree.stage_size(N - 1)
    P[N - 1] = np.broadcast_to(eye_x, (m_leaf, nx, nx)).copy()

    for t in range(N - 2, -1, -1):
        m = 1 if uniform else tree.stage_size(t)
        if uniform:
            Pc = np.broadcast_to(P[t + 1][:, None], (1, d, nx, nx))
        else:
            Pc = P[t + 1].reshape(m, d, nx, nx)
        sum_r = np.einsum("dxu,mdxy,dyv->muv", B, Pc, B)
        sum_k = np.einsum("dxu,mdxy,dyv->muv", B, Pc, A)
        Rt = eye_u + 0.5 * (sum_r + np.swapaxes(sum_r, -1, -2))
        Rtinv[t] = np.linalg.inv(Rt)
        K[t] = -np.einsum("muv,mvx->mux", Rtinv[t], sum_k)
        ABK[t] = A[None] + np.einsum("dxu,muy->mdxy", B, K[t])
        PB[t] = np.einsum("mdxy,dyu->mdxu", Pc, B)
        P[t] = (
            eye_x
            + np.einsum("mux,muy->mxy", K[t], K[t])
            + np.einsum("mdxy,mdxw,mdwv->myv", ABK[t], Pc, ABK[t])
        )

    return RiccatiData(
        P=tuple(P), K=tuple(K), Rtinv=tuple(Rtinv), ABK=tuple(ABK), PB=tuple(PB)
    )


def _kernel_projectors(risk: RiskSpec, d: int, uniform: bool) -> np.ndarray:
    """Orthogonal projectors onto ker([E' -I -I; F' 0 0]) per non-leaf node,
    from a batched SVD."""
    E, F = risk.E, risk.F
    if uniform:
        E, F = E[:1], F[:1]
    n_nl, ny, _ = E.shape
    nf = F.shape[-1]
    eye_d = np.eye(d)
    M = np.concatenate(
        [
            np.concatenate(
                [np.swapaxes(E, -1, -2), -np.broadcast_to(eye_d, (n_nl, d, d)),
                 -np.broadcast_to(eye_d, (n_nl, d, d))], axis=-1
            ),
            np.concatenate(
                [np.swapaxes(F, -1, -2), np.zeros((n_nl, nf, d)),
                 np.zeros((n_nl, nf, d))], axis=-1
            ),
        ],
        axis=-2,
    )  # [n_nl, d + nf, ny + 2d]
    _, sv, Vh = np.linalg.svd(M, full_matrices=True)
    tol = np.finfo(np.float64).eps * max(M.shape[-2:]) * sv.max(initial=1.0)
    ranks = (sv > tol).sum(axis=-1)
    r = int(ranks.max())
    if not (ranks == r).all():
        raise ValueError("Risk-measure kernel ranks differ across nodes.")
    Vn = np.swapaxes(Vh[:, r:, :], -1, -2)  # [n_nl, ny+2d, k]
    return np.einsum("nik,njk->nij", Vn, Vn)


def _is_uniform(a: np.ndarray) -> bool:
    return a.shape[0] == 1 or bool(np.all(a == a[:1]))


def build(
    spec: Spec,
    dtype: torch.dtype = torch.float32,
    device=None,
    l_norm_iters: int = 50,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[ProblemData, ProblemMeta]:
    """Offline phase: factorize, ship to ``device`` (default: the card),
    and estimate ||L||^2 by power iteration in ``dtype`` on that device."""
    device = resolve_device(device)
    tree = spec.tree
    A = np.asarray(spec.dynamics.A, dtype=np.float64)
    B = np.asarray(spec.dynamics.B, dtype=np.float64)
    d, nx, nu = A.shape[0], A.shape[-1], B.shape[-1]
    if d != tree.d:
        raise ValueError("dynamics realization count must equal the branching "
                         f"factor: {d} != {tree.d}")

    Q = np.asarray(spec.cost.Q, dtype=np.float64)
    R = np.asarray(spec.cost.R, dtype=np.float64)
    QN = np.asarray(spec.cost.QN, dtype=np.float64)
    Q = Q[:1] if _is_uniform(Q) else Q
    R = R[:1] if _is_uniform(R) else R
    QN = QN[:1] if _is_uniform(QN) else QN

    risk = spec.risk
    E = np.asarray(risk.E, np.float64)
    F = np.asarray(risk.F, np.float64)
    b = np.asarray(risk.b, np.float64)
    risk_uniform = _is_uniform(E) and _is_uniform(F) and _is_uniform(b)
    if risk_uniform:
        E, F, b = E[:1], F[:1], b[:1]

    # The S1 projection uses identity weights whatever Q/R are, so the
    # Riccati factors depend only on the dynamics: always stage-uniform.
    ric = _riccati_offline(tree, A, B, uniform=True)
    ker = _kernel_projectors(
        RiskSpec(E=E, F=F, b=b, cone=risk.cone), d, uniform=risk_uniform
    )

    poly = spec.polytope
    meta = ProblemMeta(
        tree=tree,
        nx=nx,
        nu=nu,
        ny=b.shape[-1],
        nf=F.shape[-1],
        cone=risk.cone,
        nc_nl=0 if poly is None else np.asarray(poly.Gx).shape[0],
        nc_lf=0 if poly is None else np.asarray(poly.GxN).shape[0],
    )

    def cvt(a):
        return torch.tensor(np.array(a, np.float64), dtype=dtype,
                            device=device)

    def vec(a, k):
        return cvt(np.broadcast_to(np.asarray(a, np.float64), (k,)))

    data = ProblemData(
        A=cvt(A),
        B=cvt(B),
        sqrtQ=cvt(_sqrtm_psd(Q)),
        sqrtR=cvt(_sqrtm_psd(R)),
        sqrtQN=cvt(_sqrtm_psd(QN)),
        E=cvt(E),
        F=cvt(F),
        b=cvt(b),
        x_min=vec(spec.constraints.x_min, nx),
        x_max=vec(spec.constraints.x_max, nx),
        u_min=vec(spec.constraints.u_min, nu),
        u_max=vec(spec.constraints.u_max, nu),
        ric=RiccatiData(**{f: tuple(cvt(a) for a in getattr(ric, f))
                           for f in RICCATI_FIELDS}),
        ker_proj=cvt(ker),
        L_sq=cvt(1.0),  # replaced below
        Gx=None if poly is None else cvt(poly.Gx),
        Gu=None if poly is None else cvt(poly.Gu),
        p_lo=None if poly is None else cvt(poly.lo),
        p_hi=None if poly is None else cvt(poly.hi),
        GxN=None if poly is None else cvt(poly.GxN),
        pN_lo=None if poly is None else cvt(poly.loN),
        pN_hi=None if poly is None else cvt(poly.hiN),
    )

    from .ops import linop  # local import: linop imports this module

    l_sq = linop.estimate_L_sq(data, meta, iters=l_norm_iters, rng=rng)
    data = dataclasses.replace(data, L_sq=cvt(l_sq))
    return data, meta


def step_size(data: ProblemData) -> float:
    """Default CP step gamma = sigma = 0.99 / ||L||, as a Python float."""
    return 0.99 / float(torch.sqrt(data.L_sq))
