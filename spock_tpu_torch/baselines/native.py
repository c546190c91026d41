"""ctypes bindings for the native C++ CPU solver (``native/spock_cpu.cpp``),
without JAX.

The counterpart of the JAX package's ``spock_tpu/baselines/native.py``: the
same C entry points (``spock_cpu_solve_cp``, ``spock_cpu_solve_sp``), the
same inputs, made here by the port's own numpy build helpers
(``problem._sqrtm_psd``, ``_kernel_projectors``, ``_riccati_offline``,
``risks.dual_cone``) and the same numpy power iteration for ||L||^2.  It is
the float64 oracle of the whole-solve checks: one CPU core, double
precision, the same splitting.  Uniform costs only (per-node Q, R or QN
raise NotImplementedError, as in the JAX package); risk data uniform or per
node, per-dimension boxes and two-sided polytope rows.

The library is built by ``g++`` from the tracked ``native/spock_cpu.cpp``
with ``native/build.sh``'s flags into ``build/spock_tpu_torch/``, named by
the hash of the source, the flags and the host's CPU features (the build
is ``-march=native``), on first use (never on import): a
temporary file renamed into place, so that parallel processes do not race.
``native/build.sh`` is never run and the tracked ``native/libspock_cpu.so``
is never loaded (the script rewrites that file).  A missing ``g++`` or a
failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from .. import problem as prob
from ..ops._build import BUILD_DIR
from ..risks import dual_cone
from ..tree import UniformTree

SOURCE = Path(__file__).resolve().parents[2] / "native" / "spock_cpu.cpp"
# native/build.sh's flags
GXX_FLAGS = ("-O3", "-march=native", "-ffast-math", "-fno-finite-math-only",
             "-shared", "-fPIC")
_KIND_CODE = {"zero": 0, "nonneg": 1, "nonpos": 2, "reals": 3, "soc": 4}

_LIB = None
_LOCK = threading.Lock()
# seconds of the build this process ran (None: the library was built before)
BUILD_SECONDS = None


def _nonleaf_perm(t: UniformTree) -> np.ndarray:
    """perm[heap_idx] = port_idx over non-leaf nodes.

    The C++ solver walks the tree in heap order (children of node i are
    d*i+1+c, so within a stage: pos = parent_pos*d + c) while the port's
    tree is sibling-major within stages (pos = c*m_parent + parent_pos,
    tree.py).  Uniform data is order-invariant; per-node risk arrays must be
    permuted into the C++ ordering."""
    d = t.d
    perm = np.zeros(t.n_nonleaf, np.int64)
    for st in range(1, t.N - 1):
        off = t.stage_offset(st)
        m_par = t.stage_size(st - 1)
        for lp in range(m_par):
            for c in range(d):
                perm[off + lp * d + c] = off + c * m_par + lp
    return perm


def _gxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the native solver cannot be built")
    return path


def _host_key() -> bytes:
    """The CPU that ``-march=native`` builds for: its feature flags."""
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("flags"):
                return line.encode()
    except OSError:
        pass
    return platform.machine().encode()


def library_path() -> Path:
    """The built library's path: build/spock_tpu_torch/libspock_cpu-<hash>.so,
    the hash over the source, the flags and the host's CPU features."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(_host_key())
    return BUILD_DIR / f"libspock_cpu-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    global BUILD_SECONDS
    gxx = _gxx()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    BUILD_SECONDS = time.perf_counter() - t0


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so = library_path()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        dp = ctypes.POINTER(ctypes.c_double)
        ip = ctypes.POINTER(ctypes.c_int32)
        argtypes = (
            [ctypes.c_int] * 5          # N d nx nu ny
            + [dp] * 7                  # A B sqrtQ sqrtR sqrtQN bvec ker
            + [ctypes.c_int]            # risk_per_node
            + [dp] * 4                  # Kfac Rtinv ABK PB
            + [dp] * 4                  # x_min x_max u_min u_max (vectors)
            + [ip, ip, ctypes.c_int]    # cones
            + [ctypes.c_int] + [dp] * 4  # nc Gx Gu plo phi
            + [ctypes.c_int] + [dp] * 3  # ncL GxN ploN phiN
            + [dp]                      # x0
            + [ctypes.c_double] * 3     # gamma sigma tol
            + [ctypes.c_long]           # max_iter
            + [dp, dp]                  # z v
        )
        for fn in (lib.spock_cpu_solve_cp, lib.spock_cpu_solve_sp):
            fn.restype = ctypes.c_long
            fn.argtypes = argtypes
        _LIB = lib
        return lib


def _c64(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float64)


class NativeSolver:
    """Chambolle-Pock or SuperMann solve on the native CPU backend, from the
    port's :class:`~spock_tpu_torch.problem.Spec`."""

    def __init__(self, spec: prob.Spec):
        t: UniformTree = spec.tree
        self.tree = t
        A, B = _c64(spec.dynamics.A), _c64(spec.dynamics.B)
        self.nx, self.nu = A.shape[-1], B.shape[-1]
        for name, arr in (("Q", spec.cost.Q), ("R", spec.cost.R),
                          ("QN", spec.cost.QN)):
            a = np.asarray(arr)
            if a.shape[0] != 1 and not np.all(a == a[:1]):
                raise NotImplementedError(
                    f"native backend: per-node {name} not supported")
        E, F, b = spec.risk.E, spec.risk.F, spec.risk.b
        self.ny = b.shape[-1]
        self.risk_per_node = int(
            b.shape[0] != 1
            and not (np.all(E == E[:1]) and np.all(F == F[:1])
                     and np.all(b == b[:1])))

        self.sqrtQ, self.sqrtR, self.sqrtQN = (
            _c64(prob._sqrtm_psd(np.asarray(a[:1], np.float64))[0])
            for a in (spec.cost.Q, spec.cost.R, spec.cost.QN))
        if self.risk_per_node:
            # [n_nl, ny] / [n_nl, m, m] with strided per-node access in C++,
            # permuted from the port's sibling-major order to heap order
            perm = _nonleaf_perm(t)
            self.b = _c64(np.broadcast_to(b, (t.n_nonleaf, self.ny))[perm])
            self.ker = _c64(prob._kernel_projectors(spec.risk, t.d,
                                                    uniform=False)[perm])
        else:
            self.b = _c64(b[0])
            self.ker = _c64(prob._kernel_projectors(
                type(spec.risk)(E=E[:1], F=F[:1], b=b[:1],
                                cone=spec.risk.cone),
                t.d, uniform=True)[0])
        ric = prob._riccati_offline(t, A, B, uniform=True)
        self.Kfac, self.Rtinv, self.ABK, self.PB = (
            _c64(np.stack([a[0] for a in f]))
            for f in (ric.K, ric.Rtinv, ric.ABK, ric.PB))
        self.A, self.B = A, B

        dc = dual_cone(spec.risk.cone)
        self.cone_kinds = np.asarray([_KIND_CODE[k] for k, _ in dc], np.int32)
        self.cone_dims = np.asarray([d_ for _, d_ in dc], np.int32)

        cst = spec.constraints

        def vec(a, dim):
            return _c64(np.broadcast_to(np.asarray(a, np.float64), (dim,)))

        self.x_min, self.x_max = vec(cst.x_min, self.nx), vec(cst.x_max,
                                                              self.nx)
        self.u_min, self.u_max = vec(cst.u_min, self.nu), vec(cst.u_max,
                                                              self.nu)

        # two-sided polytopes (dual rows appended to v)
        poly = spec.polytope
        if poly is not None and poly.Gx is not None:
            self.Gx, self.Gu = _c64(poly.Gx), _c64(poly.Gu)
            self.plo, self.phi = _c64(poly.lo), _c64(poly.hi)
            self.nc = self.Gx.shape[0]
        else:
            self.Gx = self.Gu = self.plo = self.phi = np.zeros(0)
            self.nc = 0
        if poly is not None and poly.GxN is not None:
            self.GxN = _c64(poly.GxN)
            self.ploN, self.phiN = _c64(poly.loN), _c64(poly.hiN)
            self.ncL = self.GxN.shape[0]
        else:
            self.GxN = self.ploN = self.phiN = np.zeros(0)
            self.ncL = 0

        self.L_sq = self._power_iteration()

        self.nz = (t.n * self.nx + t.n_nonleaf * self.nu + t.n + (t.n - 1)
                   + t.n_nonleaf * self.ny)
        self.nv = (t.n_nonleaf * self.ny + t.n_nonleaf
                   + (t.n - 1) * (self.nx + self.nu + 2)
                   + t.n_nonleaf * (self.nx + self.nu)
                   + t.n_leaf * (2 * self.nx + 2)
                   + t.n_nonleaf * self.nc + t.n_leaf * self.ncL)
        self.z = np.zeros(self.nz)
        self.v = np.zeros(self.nv)

    def _power_iteration(self, iters: int = 60) -> float:
        """numpy estimate of ||L||^2 (the math of ops.linop's power
        iteration, on the host in float64), with a 2% margin."""
        t = self.tree
        rng = np.random.default_rng(0)
        nx, nu, ny, d = self.nx, self.nu, self.ny, t.d
        x = rng.standard_normal((t.n, nx))
        u = rng.standard_normal((t.n_nonleaf, nu))
        s = rng.standard_normal(t.n)
        tau = rng.standard_normal(t.n - 1)
        y = rng.standard_normal((t.n_nonleaf, ny))
        lam = 1.0
        for _ in range(iters):
            # L
            xp = np.repeat(x[:t.n_nonleaf], d, axis=0)
            up = np.repeat(u, d, axis=0)
            bmat = (self.b if self.risk_per_node
                    else np.broadcast_to(self.b, (t.n_nonleaf, ny)))
            v1 = y
            v2 = s[:t.n_nonleaf] - np.sum(y * bmat, axis=-1)
            v3 = xp @ self.sqrtQ.T
            v4 = up @ self.sqrtR.T
            v5 = v6 = 0.5 * tau
            v7x, v7u = x[:t.n_nonleaf], u
            v11 = x[t.leaf_start:] @ self.sqrtQN.T
            v12 = v13 = 0.5 * s[t.leaf_start:]
            v14 = x[t.leaf_start:]
            vp = vpN = None
            if self.nc:
                vp = x[:t.n_nonleaf] @ self.Gx.T + u @ self.Gu.T
            if self.ncL:
                vpN = x[t.leaf_start:] @ self.GxN.T
            # L'
            xn = v7x + (v3 @ self.sqrtQ).reshape(t.n_nonleaf, d, nx).sum(1)
            xl = v14 + v11 @ self.sqrtQN
            un = v7u + (v4 @ self.sqrtR).reshape(t.n_nonleaf, d, nu).sum(1)
            if self.nc:
                xn = xn + vp @ self.Gx
                un = un + vp @ self.Gu
            if self.ncL:
                xl = xl + vpN @ self.GxN
            yn = v1 - bmat * v2[:, None]
            taun = 0.5 * (v5 + v6)
            sn = np.concatenate([v2, 0.5 * (v12 + v13)])
            w = (np.concatenate([xn, xl]), un, sn, taun, yn)
            nrm_sq = sum(float(np.sum(a * a)) for a in w)
            dot = (float(np.sum(w[0] * x)) + float(np.sum(w[1] * u))
                   + float(np.sum(w[2] * s)) + float(np.sum(w[3] * tau))
                   + float(np.sum(w[4] * y)))
            denom = (float(np.sum(x * x)) + float(np.sum(u * u))
                     + float(np.sum(s * s)) + float(np.sum(tau * tau))
                     + float(np.sum(y * y)))
            lam = dot / max(denom, 1e-30)
            nrm = np.sqrt(max(nrm_sq, 1e-30))
            x, u, s, tau, y = (a / nrm for a in w)
        return lam * 1.02

    def solve(self, x0, tol: float = 1e-3, max_iter: int = 5000,
              warm_start: bool = True, algorithm: str = "cp"):
        """Returns dict(x, u, s, tau, y, iterations, converged, objective).
        z/v persist across calls (an implicit warm start, like the
        reference).  algorithm: "cp" or "spock" (SuperMann + Anderson)."""
        lib = _lib()
        t = self.tree
        if not warm_start:
            self.z[:] = 0.0
            self.v[:] = 0.0
        step = 0.99 / np.sqrt(self.L_sq)
        x0 = _c64(x0)
        dp = ctypes.POINTER(ctypes.c_double)
        ip = ctypes.POINTER(ctypes.c_int32)

        def as_dp(a):
            return a.ctypes.data_as(dp)

        fn = (lib.spock_cpu_solve_sp if algorithm == "spock"
              else lib.spock_cpu_solve_cp)
        it = fn(
            t.N, t.d, self.nx, self.nu, self.ny,
            as_dp(self.A), as_dp(self.B), as_dp(self.sqrtQ),
            as_dp(self.sqrtR), as_dp(self.sqrtQN), as_dp(self.b),
            as_dp(self.ker), self.risk_per_node,
            as_dp(self.Kfac), as_dp(self.Rtinv), as_dp(self.ABK),
            as_dp(self.PB),
            as_dp(self.x_min), as_dp(self.x_max), as_dp(self.u_min),
            as_dp(self.u_max),
            self.cone_kinds.ctypes.data_as(ip),
            self.cone_dims.ctypes.data_as(ip), len(self.cone_dims),
            self.nc, as_dp(self.Gx), as_dp(self.Gu), as_dp(self.plo),
            as_dp(self.phi),
            self.ncL, as_dp(self.GxN), as_dp(self.ploN), as_dp(self.phiN),
            as_dp(x0), step, step, tol, max_iter, as_dp(self.z),
            as_dp(self.v))
        converged = it >= 0
        iters = it if converged else -1 - it
        nx, nu, ny = self.nx, self.nu, self.ny
        ox, ou = 0, t.n * nx
        os_ = ou + t.n_nonleaf * nu
        ot = os_ + t.n
        oy = ot + t.n - 1
        return {
            "x": self.z[ox:ou].reshape(t.n, nx).copy(),
            "u": self.z[ou:os_].reshape(t.n_nonleaf, nu).copy(),
            "s": self.z[os_:ot].copy(),
            "tau": self.z[ot:oy].copy(),
            "y": self.z[oy:].reshape(t.n_nonleaf, ny).copy(),
            "iterations": iters,
            "converged": converged,
            "objective": float(self.z[os_]),
        }
