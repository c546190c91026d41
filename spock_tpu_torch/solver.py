"""User-facing solve API.

    data, meta = spock_tpu_torch.build(spec)          # on the card
    solver = Solver(data, meta, algorithm="spock")
    res = solver.solve(x0)                           # cold start
    res = solver.solve(x0, z0=res.z, v0=res.v)       # warm start

Pass ``device="cpu"`` to both ``build`` and ``Solver`` to run on the CPU.
Warm starting is explicit state passing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .algorithms import cp as cp_alg
from .algorithms import supermann as sp_alg
from .algorithms.common import SolveResult
from .problem import ProblemData, ProblemMeta, resolve_device
from .zv import Dual, Primal, tmap


def zero_primal(meta: ProblemMeta, batch: tuple = (), dtype=torch.float32,
                device=None) -> Primal:
    t = meta.tree
    device = resolve_device(device)

    def z(*s):
        return torch.zeros(batch + s, dtype=dtype, device=device)

    return Primal(x=z(meta.nx, t.n), u=z(meta.nu, t.n_nonleaf), s=z(t.n),
                  tau=z(t.n - 1), y=z(meta.ny, t.n_nonleaf))


def zero_dual(meta: ProblemMeta, batch: tuple = (), dtype=torch.float32,
              device=None) -> Dual:
    t = meta.tree
    device = resolve_device(device)

    def z(*s):
        return torch.zeros(batch + s, dtype=dtype, device=device)

    return Dual(
        y=z(meta.ny, t.n_nonleaf),
        sby=z(t.n_nonleaf),
        qx=z(meta.nx, t.n - 1),
        ru=z(meta.nu, t.n - 1),
        t5=z(t.n - 1),
        t6=z(t.n - 1),
        cx=z(meta.nx, t.n_nonleaf),
        cu=z(meta.nu, t.n_nonleaf),
        qNx=z(meta.nx, t.n_leaf),
        s12=z(t.n_leaf),
        s13=z(t.n_leaf),
        cxN=z(meta.nx, t.n_leaf),
        pnl=z(meta.nc_nl, t.n_nonleaf) if meta.nc_nl > 0 else None,
        plf=z(meta.nc_lf, t.n_leaf) if meta.nc_lf > 0 else None,
    )


def check_device(data: ProblemData, device) -> torch.device:
    """The entry point's device (default: the card), which must be the
    data's."""
    device = resolve_device(device)
    if data.device.type != device.type or (
            device.index is not None and data.device != device):
        raise ValueError(f"problem data lives on {data.device}, but the "
                         f"entry point runs on {device}")
    return data.device


@dataclasses.dataclass
class Solver:
    """algorithm: "spock" (CP + SuperMann + Anderson, default) or "cp"
    (plain Chambolle-Pock).  device: None means the card.  fused_sweep: one
    kernel launch per CP sweep where the sweep kernels cover the problem
    (default); False takes the composed path (PyTorch operators and the
    prox_h* kernel).  fused_step: one kernel launch per SuperMann iteration
    where ``supermann.use_fused_step`` holds (default).  constrain: an
    optional ``tree -> tree`` hook applied to the iterates (z, v) every
    iteration (the JAX package's sharding hook; never the fused step)."""

    data: ProblemData
    meta: ProblemMeta
    algorithm: str = "spock"
    max_iter: Optional[int] = None  # defaults: 1000 spock / 5000 cp
    lam: float = 1.0
    supermann: Optional[sp_alg.SuperMannOpts] = None
    device: Optional[str] = None
    fused_sweep: bool = True
    fused_step: bool = True
    constrain: object = None

    def __post_init__(self):
        if self.algorithm not in ("spock", "cp"):
            raise ValueError(f"unknown algorithm {self.algorithm!r}")
        if self.max_iter is None:
            self.max_iter = 1000 if self.algorithm == "spock" else 5000
        if self.supermann is None:
            self.supermann = sp_alg.SuperMannOpts()
        self.device = check_device(self.data, self.device)

    @property
    def dtype(self):
        return self.data.dtype

    def solve(self, x0, z0: Optional[Primal] = None, v0: Optional[Dual] = None,
              tol: float = 1e-3) -> SolveResult:
        """x0: [nx] or [B, nx].  Returns a batched SolveResult ([B] lanes;
        B=1 squeezed back out for unbatched input)."""
        x0 = torch.as_tensor(x0, dtype=self.dtype, device=self.device)
        unbatched = x0.ndim == 1
        if unbatched:
            x0 = x0[None]
        B = x0.shape[0]
        if z0 is None:
            z0 = zero_primal(self.meta, (B,), self.dtype, self.device)
        if v0 is None:
            v0 = zero_dual(self.meta, (B,), self.dtype, self.device)
        if self.algorithm == "cp":
            res = cp_alg.run_cp(self.data, self.meta, x0, z0, v0, tol=tol,
                                max_iter=int(self.max_iter), lam=self.lam,
                                fused_sweep=self.fused_sweep,
                                constrain=self.constrain)
        else:
            res = sp_alg.run_supermann(self.data, self.meta, x0, z0, v0,
                                       tol=tol, max_iter=int(self.max_iter),
                                       opts=self.supermann,
                                       fused_sweep=self.fused_sweep,
                                       fused_step=self.fused_step,
                                       constrain=self.constrain)
        if unbatched:
            res = tmap(lambda a: a[0], res)
        return res
