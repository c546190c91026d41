"""Independent sparse first-order conic oracle (ADMM, CPU, float64).

An explicit sparse-matrix method, independent of the splitting solver's
implicit-operator sweeps, that certifies it where the dense SLSQP oracle
(``scipy_ref.py``) becomes intractable.  It solves the sparse conic
standard form

      min c'z   s.t.  A z + s = b,   s in K,
      K = {0}^m_eq x R_+^m_in x SOC x ... x SOC,

with proximal ADMM: a cached sparse LU of the (rho-independent) KKT
matrix [[delta I, A'], [A, -I]], Ruiz equilibration (SOC blocks scaled
uniformly so the cone is preserved), over-relaxation, and adaptive rho.
numpy and scipy only, on the port's own ``Spec``; the same method as the JAX
package's ``baselines/admm_ref.py``.

The quadratic epigraphs enter as the same SOC encoding the whole framework
uses (``docs/math.md``): ||(sqrtQ x, sqrtR u, t/2 - 1/2)|| <= t/2 + 1/2.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy import sparse
from scipy.sparse import linalg as spla

from ..problem import Spec, _sqrtm_psd
from ..risks import dual_cone
from ..tree import UniformTree


@dataclasses.dataclass(frozen=True)
class _ConicProgram:
    """min c'z s.t. A z + s = b, s in K.

    K is [0, m_eq) zero cone, [m_eq, m_eq + m_in) nonneg, then SOC blocks
    ``soc`` = list of (row_offset, dim) with t-first ordering.
    """

    A: sparse.csc_matrix
    b: np.ndarray
    c: np.ndarray
    m_eq: int
    m_in: int
    soc: tuple  # ((offset, dim), ...)
    # variable unstacking info
    n: int
    n_nl: int
    nx: int
    nu: int
    ny: int


def _build(spec: Spec, x0: np.ndarray) -> _ConicProgram:
    t: UniformTree = spec.tree
    A_dyn = np.asarray(spec.dynamics.A, float)
    B_dyn = np.asarray(spec.dynamics.B, float)
    nx, nu = A_dyn.shape[-1], B_dyn.shape[-1]
    n, n_nl, n_lf = t.n, t.n_nonleaf, t.n_leaf
    E = np.asarray(spec.risk.E, float)
    F = np.asarray(spec.risk.F, float)
    bb = np.asarray(spec.risk.b, float)
    ny = bb.shape[-1]
    x0 = np.asarray(x0, float)

    def nodemat(M, i):
        return M[0] if M.shape[0] == 1 else M[i]

    sqQ = _sqrtm_psd(np.asarray(spec.cost.Q, float))
    sqR = _sqrtm_psd(np.asarray(spec.cost.R, float))
    sqQN = _sqrtm_psd(np.asarray(spec.cost.QN, float))

    # variable stacking: [x (n*nx), u (n_nl*nu), s (n), tau (n-1), y (n_nl*ny)]
    ox, ou = 0, n * nx
    os_, ot = ou + n_nl * nu, ou + n_nl * nu + n
    oy = ot + (n - 1)
    nvar = oy + n_nl * ny

    rows, cols, vals, rhs = [], [], [], []
    mrow = 0

    def add_row(col_idx, col_val, b_val):
        nonlocal mrow
        rows.extend([mrow] * len(col_idx))
        cols.extend(col_idx)
        vals.extend(col_val)
        rhs.append(b_val)
        mrow += 1

    def add_mat_rows(mat_blocks, b_vals):
        """mat_blocks: list of (col_offset, dense [r, k] or None-skip);
        all blocks share the row count r."""
        r = len(b_vals)
        for q in range(r):
            ci, cv = [], []
            for off, M in mat_blocks:
                nz = np.nonzero(M[q])[0]
                ci.extend(off + nz)
                cv.extend(M[q, nz])
            add_row(ci, cv, b_vals[q])

    # ---- zero cone ----
    # root pin x_0 = x0
    add_mat_rows([(ox, np.eye(nx))], x0)
    # dynamics x_j - A_w x_i - B_w u_i = 0
    for j in range(1, n):
        i, w = t.parent(j), t.w(j)
        add_mat_rows(
            [
                (ox + j * nx, np.eye(nx)),
                (ox + i * nx, -A_dyn[w]),
                (ou + i * nu, -B_dyn[w]),
            ],
            np.zeros(nx),
        )
    # risk equalities E'y - tau_child - s_child = 0; F'y = 0 (nonzero rows)
    for i in range(n_nl):
        Ei, Fi = nodemat(E, i), nodemat(F, i)
        kids = list(t.children(i))
        for kk, j in enumerate(kids):
            ci = list(oy + i * ny + np.arange(ny)) + [ot + j - 1, os_ + j]
            cv = list(Ei[:, kk]) + [-1.0, -1.0]
            add_row(ci, cv, 0.0)
        for kf in range(Fi.shape[1]):
            if np.abs(Fi[:, kf]).sum() > 0:
                nz = np.nonzero(Fi[:, kf])[0]
                add_row(list(oy + i * ny + nz), list(Fi[nz, kf]), 0.0)
    # y 'zero' dual-cone segments
    dual = dual_cone(spec.risk.cone)
    for i in range(n_nl):
        seg = 0
        for kind, dim in dual:
            if kind == "zero":
                for q in range(dim):
                    add_row([oy + i * ny + seg + q], [1.0], 0.0)
            seg += dim
    m_eq = mrow

    # ---- nonneg cone (A z <= b) ----
    # b'y - s_i <= 0
    for i in range(n_nl):
        bi = nodemat(bb, i)
        nz = np.nonzero(bi)[0]
        add_row(list(oy + i * ny + nz) + [os_ + i], list(bi[nz]) + [-1.0], 0.0)
    # boxes (finite bounds only)
    xminb = np.broadcast_to(np.asarray(spec.constraints.x_min, float), (nx,))
    xmaxb = np.broadcast_to(np.asarray(spec.constraints.x_max, float), (nx,))
    uminb = np.broadcast_to(np.asarray(spec.constraints.u_min, float), (nu,))
    umaxb = np.broadcast_to(np.asarray(spec.constraints.u_max, float), (nu,))
    for i in range(n):
        for k in range(nx):
            if np.isfinite(xmaxb[k]):
                add_row([ox + i * nx + k], [1.0], xmaxb[k])
            if np.isfinite(xminb[k]):
                add_row([ox + i * nx + k], [-1.0], -xminb[k])
    for i in range(n_nl):
        for k in range(nu):
            if np.isfinite(umaxb[k]):
                add_row([ou + i * nu + k], [1.0], umaxb[k])
            if np.isfinite(uminb[k]):
                add_row([ou + i * nu + k], [-1.0], -uminb[k])
    # polytope rows
    if spec.polytope is not None:
        P = spec.polytope
        Gx, Gu = np.asarray(P.Gx, float), np.asarray(P.Gu, float)
        lo, hi = np.asarray(P.lo, float), np.asarray(P.hi, float)
        GxN = np.asarray(P.GxN, float)
        loN, hiN = np.asarray(P.loN, float), np.asarray(P.hiN, float)
        for i in range(n_nl):
            for q in range(Gx.shape[0]):
                ci = list(ox + i * nx + np.arange(nx)) + list(
                    ou + i * nu + np.arange(nu)
                )
                cv = list(Gx[q]) + list(Gu[q])
                if np.isfinite(hi[q]):
                    add_row(ci, cv, hi[q])
                if np.isfinite(lo[q]):
                    add_row(ci, [-v for v in cv], -lo[q])
        for k in range(n_lf):
            i = t.leaf_start + k
            for q in range(GxN.shape[0]):
                ci = list(ox + i * nx + np.arange(nx))
                if np.isfinite(hiN[q]):
                    add_row(ci, list(GxN[q]), hiN[q])
                if np.isfinite(loN[q]):
                    add_row(ci, list(-GxN[q]), -loN[q])
    # y nonneg / nonpos dual-cone segments
    for i in range(n_nl):
        seg = 0
        for kind, dim in dual:
            if kind == "nonneg":
                for q in range(dim):
                    add_row([oy + i * ny + seg + q], [-1.0], 0.0)
            elif kind == "nonpos":
                for q in range(dim):
                    add_row([oy + i * ny + seg + q], [1.0], 0.0)
            seg += dim
    m_in = mrow - m_eq

    # ---- SOC blocks (t first): A z + s = b with s in SOC ----
    soc = []
    # stage cost epigraphs per non-root j (cost indexed j-1, applied at parent)
    for j in range(1, n):
        i = t.parent(j)
        soc.append((mrow, nx + nu + 2))
        add_row([ot + j - 1], [-0.5], 0.5)  # t = tau/2 + 1/2
        add_mat_rows([(ox + i * nx, -nodemat(sqQ, j - 1))], np.zeros(nx))
        add_mat_rows([(ou + i * nu, -nodemat(sqR, j - 1))], np.zeros(nu))
        add_row([ot + j - 1], [-0.5], -0.5)  # w_last = tau/2 - 1/2
    # terminal epigraphs per leaf
    for k in range(n_lf):
        i = t.leaf_start + k
        soc.append((mrow, nx + 2))
        add_row([os_ + i], [-0.5], 0.5)
        add_mat_rows([(ox + i * nx, -nodemat(sqQN, k))], np.zeros(nx))
        add_row([os_ + i], [-0.5], -0.5)
    # y SOC dual-cone segments
    for i in range(n_nl):
        seg = 0
        for kind, dim in dual:
            if kind == "soc":
                soc.append((mrow, dim))
                for q in range(dim):
                    add_row([oy + i * ny + seg + q], [-1.0], 0.0)
            elif kind in ("nonneg", "nonpos", "zero", "reals"):
                pass
            else:
                raise NotImplementedError(f"cone segment {kind!r}")
            seg += dim

    A = sparse.csc_matrix(
        (vals, (rows, cols)), shape=(mrow, nvar), dtype=float
    )
    c = np.zeros(nvar)
    c[os_] = 1.0  # min s_root
    return _ConicProgram(
        A=A, b=np.asarray(rhs), c=c, m_eq=m_eq, m_in=m_in,
        soc=tuple(soc), n=n, n_nl=n_nl, nx=nx, nu=nu, ny=ny,
    )


def _proj_K(prog: _ConicProgram, s: np.ndarray) -> np.ndarray:
    out = s.copy()
    out[: prog.m_eq] = 0.0
    lo = prog.m_eq
    np.maximum(out[lo : lo + prog.m_in], 0.0, out=out[lo : lo + prog.m_in])
    # group contiguous same-dim SOC blocks for vectorized projection
    i = 0
    socs = prog.soc
    while i < len(socs):
        off, dim = socs[i]
        j = i
        while (
            j + 1 < len(socs)
            and socs[j + 1][1] == dim
            and socs[j + 1][0] == socs[j][0] + dim
        ):
            j += 1
        nblk = j - i + 1
        blk = out[off : off + nblk * dim].reshape(nblk, dim)
        tt = blk[:, 0]
        w = blk[:, 1:]
        nw = np.linalg.norm(w, axis=1)
        # inside (t >= ||w||): keep; polar (t <= -||w||): zero; else scale
        scale = np.clip((tt + nw) / np.maximum(2.0 * nw, 1e-300), 0.0, 1.0)
        mid = nw > tt  # rows needing modification (incl. polar)
        blk[mid, 0] = (scale * nw)[mid]
        blk[mid, 1:] = (scale[:, None] * w)[mid]
        polar = tt <= -nw
        blk[polar] = 0.0
        i = j + 1
    return out


def _ruiz(prog: _ConicProgram, iters: int = 10):
    """Ruiz equilibration D A Ev with uniform scaling inside each SOC block
    (so D s in K <=> s in K after per-block uniformization)."""
    A = prog.A.tocsr()
    m, nvar = A.shape
    d = np.ones(m)
    e = np.ones(nvar)
    soc_index = np.full(m, -1)
    for bi, (off, dim) in enumerate(prog.soc):
        soc_index[off : off + dim] = bi
    for _ in range(iters):
        Aabs = sparse.csr_matrix(
            (np.abs(A.data), A.indices, A.indptr), shape=A.shape
        )
        rmax = np.asarray(Aabs.max(axis=1).todense()).ravel()
        rmax[rmax == 0] = 1.0
        dr = 1.0 / np.sqrt(rmax)
        # uniformize inside each SOC block (geometric mean)
        for off, dim in prog.soc:
            g = np.exp(np.mean(np.log(dr[off : off + dim])))
            dr[off : off + dim] = g
        cmax = np.asarray(Aabs.max(axis=0).todense()).ravel()
        cmax[cmax == 0] = 1.0
        de = 1.0 / np.sqrt(cmax)
        A = sparse.diags(dr) @ A @ sparse.diags(de)
        d *= dr
        e *= de
    return A.tocsc(), d, e


def solve(
    spec: Spec,
    x0,
    tol: float = 1e-8,
    max_iter: int = 200_000,
    rho: float = 1.0,
    alpha: float = 1.6,
    verbose: bool = False,
):
    """Solve the risk-averse OCP for one initial state with sparse conic
    ADMM.  Returns the same dict keys as :func:`scipy_ref.solve` plus
    ``iterations`` and the final residuals.

    ``tol`` bounds BOTH the relative primal and dual residuals (OSQP-style
    stopping); pass ~1e-8 for an oracle-grade solution.
    """
    prog = _build(spec, x0)
    As, d, e = _ruiz(prog)
    bs = d * prog.b
    cs = e * prog.c

    m, nvar = As.shape
    delta = 1e-6
    K = sparse.bmat(
        [[delta * sparse.eye(nvar), As.T], [As, -sparse.eye(m)]],
        format="csc",
    )
    lu = spla.splu(K)

    z = np.zeros(nvar)
    s = _proj_K(prog, bs.copy())
    u = np.zeros(m)
    cnorm = max(np.linalg.norm(prog.c), 1.0)
    bnorm = max(np.linalg.norm(prog.b), 1.0)
    dinv, einv = 1.0 / d, 1.0 / e

    it = 0
    converged = False
    for it in range(1, max_iter + 1):
        rhs = np.concatenate([delta * z - cs / rho, bs - s - u])
        sol = lu.solve(rhs)
        z = sol[:nvar]
        Az = As @ z
        Az_rel = alpha * Az - (1.0 - alpha) * (s - bs)
        s_new = _proj_K(prog, bs - Az_rel - u)
        u = u + Az_rel + s_new - bs
        ds = s_new - s
        s = s_new

        if it % 25 == 0 or it == max_iter:
            # residuals mapped back to the original (unscaled) space:
            # A = D^-1 As E^-1, s_orig = D^-1 s, b = D^-1 bs
            pri = np.linalg.norm(dinv * (Az + s - bs))
            dua = rho * np.linalg.norm(einv * (As.T @ (dinv * dinv * ds)))
            pri_rel = pri / max(
                bnorm,
                np.linalg.norm(dinv * Az),
                np.linalg.norm(dinv * s),
            )
            dua_rel = dua / cnorm
            if verbose and it % 500 == 0:
                print(f"  admm it={it} pri={pri_rel:.2e} dua={dua_rel:.2e}")
            if pri_rel < tol and dua_rel < tol:
                converged = True
                break
            # adaptive rho (KKT matrix is rho-independent: free)
            if pri_rel > 10.0 * dua_rel:
                rho *= 2.0
                u /= 2.0
            elif dua_rel > 10.0 * pri_rel:
                rho /= 2.0
                u *= 2.0

    zf = e * z  # unscale
    n, n_nl = prog.n, prog.n_nl
    nx, nu, ny = prog.nx, prog.nu, prog.ny
    ox, ou = 0, n * nx
    os_, ot = ou + n_nl * nu, ou + n_nl * nu + n
    oy = ot + (n - 1)
    return {
        "x": zf[ox:ou].reshape(n, nx),
        "u": zf[ou:os_].reshape(n_nl, nu),
        "s": zf[os_:ot],
        "tau": zf[ot:oy],
        "y": zf[oy:].reshape(n_nl, ny),
        "objective": zf[os_],
        "iterations": it,
        "converged": converged,
    }
