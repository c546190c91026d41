"""Carry problem data and iterates across from the JAX package, as numpy.

The JAX side hands its ``ProblemData`` over as numpy leaves, e.g.
``jax.tree_util.tree_map(np.asarray, data)``; any object with the same
attribute names works, and ``ric`` may be an object with the Riccati field
names or a tuple of the five per-stage tuples (P, K, Rtinv, ABK, PB).  This
module reads attributes only; it imports nothing of the JAX package.  Like
``build``, every function here puts its tensors on the card unless given a
``device`` (``device="cpu"`` for the CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .problem import (
    RICCATI_FIELDS, ProblemData, ProblemMeta, RiccatiData, resolve_device)
from .tree import UniformTree
from .zv import Dual, Primal


def _tensor(a, dtype, device):
    if a is None:
        return None
    return torch.tensor(np.array(a), dtype=dtype, device=device)


def meta_from(m) -> ProblemMeta:
    """The port's ProblemMeta from any object with the same fields."""
    return ProblemMeta(
        tree=UniformTree(N=int(m.tree.N), d=int(m.tree.d)),
        nx=int(m.nx), nu=int(m.nu), ny=int(m.ny), nf=int(m.nf),
        cone=tuple((str(k), int(dim)) for k, dim in m.cone),
        nc_nl=int(m.nc_nl), nc_lf=int(m.nc_lf),
    )


def problem_data_from_numpy(arrays, meta: ProblemMeta, dtype=torch.float64,
                            device=None) -> ProblemData:
    """ProblemData from numpy arrays with the JAX ``ProblemData`` layout."""
    device = resolve_device(device)
    ric = arrays.ric
    if isinstance(ric, tuple):
        parts = dict(zip(RICCATI_FIELDS, ric))
    else:
        parts = {f: getattr(ric, f) for f in RICCATI_FIELDS}
    fields = {}
    for fl in dataclasses.fields(ProblemData):
        if fl.name == "ric":
            continue
        fields[fl.name] = _tensor(getattr(arrays, fl.name, None), dtype,
                                  device)
    if (meta.nc_nl > 0) != (fields["Gx"] is not None):
        raise ValueError("the polytope arrays do not match meta.nc_nl")
    fields["ric"] = RiccatiData(**{
        f: tuple(_tensor(a, dtype, device) for a in parts[f])
        for f in RICCATI_FIELDS})
    return ProblemData(**fields)


def primal_from_numpy(z, dtype=torch.float64, device=None) -> Primal:
    """Primal from any object with fields x, u, s, tau, y (numpy leaves)."""
    device = resolve_device(device)
    return Primal(**{fl.name: _tensor(getattr(z, fl.name), dtype, device)
                     for fl in dataclasses.fields(Primal)})


def dual_from_numpy(v, dtype=torch.float64, device=None) -> Dual:
    """Dual from any object with the Dual field names (numpy leaves)."""
    device = resolve_device(device)
    return Dual(**{fl.name: _tensor(getattr(v, fl.name, None), dtype, device)
                   for fl in dataclasses.fields(Dual)})
