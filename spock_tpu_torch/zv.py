"""Structured primal/dual iterates as plain dataclasses of tensors.

The layout is the JAX package's (``spock_tpu/zv.py``): feature-major, the
node axis always last, with any leading batch (lane) dims.  ``n``,
``n_nonleaf`` and ``n_leaf`` refer to :class:`spock_tpu_torch.tree.UniformTree`.

:func:`tmap` maps a function over the tensor leaves of a Primal, a Dual, or
tuples of them; ``None`` fields (the optional polytope blocks) stay ``None``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class Primal:
    """Primal iterate z = (x, u, s, tau, y).

      x:   [nx, n]          state at every node.
      u:   [nu, n_nonleaf]  input at every non-leaf node.
      s:   [n]              epigraph variable per node (s[0] is the objective).
      tau: [n - 1]          stage-cost epigraph per non-root node (tau[j-1]
                            belongs to node j).
      y:   [ny, n_nonleaf]  risk dual per non-leaf node.
    """

    x: Any
    u: Any
    s: Any
    tau: Any
    y: Any


@dataclasses.dataclass(frozen=True)
class Dual:
    """Dual iterate v, one field per block of the linear operator L.

      y:    [ny, n_nonleaf] copy of z.y
      sby:  [n_nonleaf]     s_i - b_i' y_i
      qx:   [nx, n - 1]     sqrtQ_j @ x_{parent(j)}
      ru:   [nu, n - 1]     sqrtR_j @ u_{parent(j)}
      t5:   [n - 1]         tau_j / 2
      t6:   [n - 1]         tau_j / 2
      cx:   [nx, n_nonleaf] x_i (non-leaf box copy)
      cu:   [nu, n_nonleaf] u_i (non-leaf box copy)
      qNx:  [nx, n_leaf]    sqrtQN_i @ x_i (leaves)
      s12:  [n_leaf]        s_i / 2 (leaves)
      s13:  [n_leaf]        s_i / 2 (leaves)
      cxN:  [nx, n_leaf]    x_i (leaf box copy)
      pnl:  [nc, n_nonleaf] Gx x_i + Gu u_i (polytope rows, or None)
      plf:  [ncN, n_leaf]   GxN x_i (leaf polytope rows, or None)
    """

    y: Any
    sby: Any
    qx: Any
    ru: Any
    t5: Any
    t6: Any
    cx: Any
    cu: Any
    qNx: Any
    s12: Any
    s13: Any
    cxN: Any
    pnl: Any = None
    plf: Any = None


DUAL_BLOCKS = ("y", "sby", "qx", "ru", "t5", "t6", "cx", "cu", "qNx", "s12",
               "s13", "cxN")


def tmap(f, *trees):
    """Apply ``f`` leafwise over matching trees (dataclasses, tuples, None)."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, tuple):
        return tuple(tmap(f, *parts) for parts in zip(*trees))
    if dataclasses.is_dataclass(t0):
        return type(t0)(**{
            fl.name: tmap(f, *(getattr(t, fl.name) for t in trees))
            for fl in dataclasses.fields(t0)
        })
    return f(*trees)


def leaves(tree):
    """The tensor leaves of a tree in field order (``None`` skipped)."""
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [l for part in tree for l in leaves(part)]
    if dataclasses.is_dataclass(tree):
        return [l for fl in dataclasses.fields(tree)
                for l in leaves(getattr(tree, fl.name))]
    return [tree]


def lincomb(a, x, b, y):
    return tmap(lambda xl, yl: a * xl + b * yl, x, y)


def sub(x, y):
    return tmap(torch.subtract, x, y)


def vdot(x, y, batch_ndim: int = 0):
    """Inner product over event dims; returns a tensor of the batch shape."""
    out = None
    for a, b in zip(leaves(x), leaves(y)):
        d = torch.sum(a * b, dim=tuple(range(batch_ndim, a.ndim)))
        out = d if out is None else out + d
    return out


def inf_norm(x, batch_ndim: int = 0):
    out = None
    for a in leaves(x):
        m = torch.amax(torch.abs(a), dim=tuple(range(batch_ndim, a.ndim)))
        out = m if out is None else torch.maximum(out, m)
    return out


def where_mask(mask, new, old):
    """Select ``new`` where ``mask`` (batch-shaped bool) else ``old``."""

    def sel(a, b):
        m = mask.reshape(mask.shape + (1,) * (a.ndim - mask.ndim))
        return torch.where(m, a, b)

    return tmap(sel, new, old)
