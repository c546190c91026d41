"""Conversion between structured (feature-major) iterates and the reference's
flat layouts.

The reference packs the primal as z = [x; u; s; tau; y] node-major and the
dual as v = [v1; v2; v3; v4; v5; v6; v7; v11; v12; v13; v14] with v7
interleaved as ((x_i, u_i))_i.  These helpers exist for cross-checking
against the reference and for external tooling; the solver itself never
flattens.

Node numbering: the engine orders each stage sibling-major (``tree.py``)
while the reference interleaves children; the conversions permute the node
axis by ``UniformTree.perm_to_reference``, so the flat vectors use the
reference's node numbering.  Flat vectors come out as numpy arrays (as the
JAX package's do); structured iterates come back as tensors on the input's
device (a numpy input: float64 on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from ..problem import ProblemMeta
from ..zv import Dual, Primal


def _nm(a):
    """Feature-major [..., f, n] -> node-major flat [..., n * f]."""
    return a.transpose(-1, -2).reshape(a.shape[:-2] + (-1,))


def _fm(flat, n, f):
    """Node-major flat [..., n * f] -> feature-major [..., f, n]."""
    return flat.reshape(flat.shape[:-1] + (n, f)).transpose(-1, -2)


def _perms(meta: ProblemMeta):
    """Gather indices over three node classes (all nodes, non-leaf,
    non-root), as (to reference order, from reference order): ours[..., inv]
    is in the reference's order, ref[..., fwd] in ours."""
    t = meta.tree
    perm = t.perm_to_reference()  # perm[our] = ref
    inv = np.empty_like(perm)
    inv[perm] = np.arange(t.n)  # inv[ref] = our
    # non-leaf ids permute among themselves; non-root position j-1 holds j
    to_ref = (inv, inv[: t.n_nonleaf], inv[1:] - 1)
    from_ref = (perm, perm[: t.n_nonleaf], perm[1:] - 1)
    return to_ref, from_ref


def _flat(parts) -> np.ndarray:
    return torch.cat(parts, dim=-1).detach().cpu().numpy()


def primal_to_ref(meta: ProblemMeta, z: Primal) -> np.ndarray:
    """[..., nz] in the reference's z layout (reference node numbering)."""
    (all_inv, nl_inv, nr_inv), _ = _perms(meta)
    return _flat([_nm(z.x[..., all_inv]), _nm(z.u[..., nl_inv]),
                  z.s[..., all_inv], z.tau[..., nr_inv],
                  _nm(z.y[..., nl_inv])])


def _segments(flat, sizes):
    flat = torch.as_tensor(flat)
    offs = np.cumsum([0] + sizes)
    return [flat[..., offs[i]: offs[i + 1]] for i in range(len(sizes))]


def primal_from_ref(meta: ProblemMeta, zf) -> Primal:
    t = meta.tree
    seg = _segments(zf, [t.n * meta.nx, t.n_nonleaf * meta.nu, t.n, t.n - 1,
                         t.n_nonleaf * meta.ny])
    _, (all_fwd, nl_fwd, nr_fwd) = _perms(meta)
    return Primal(
        x=_fm(seg[0], t.n, meta.nx)[..., all_fwd],
        u=_fm(seg[1], t.n_nonleaf, meta.nu)[..., nl_fwd],
        s=seg[2][..., all_fwd],
        tau=seg[3][..., nr_fwd],
        y=_fm(seg[4], t.n_nonleaf, meta.ny)[..., nl_fwd],
    )


def dual_to_ref(meta: ProblemMeta, v: Dual) -> np.ndarray:
    """[..., nv] in the reference's v layout (v7 interleaved per node,
    reference node numbering).  The polytope blocks (pnl/plf) have no
    reference counterpart and are appended at the end when present."""
    t = meta.tree
    (all_inv, nl_inv, nr_inv), _ = _perms(meta)
    lf_inv = all_inv[t.leaf_start:] - t.leaf_start  # leaves among themselves
    v7 = torch.cat([v.cx, v.cu], dim=-2)  # [..., nx+nu, n_nl]
    parts = [
        _nm(v.y[..., nl_inv]), v.sby[..., nl_inv], _nm(v.qx[..., nr_inv]),
        _nm(v.ru[..., nr_inv]), v.t5[..., nr_inv], v.t6[..., nr_inv],
        _nm(v7[..., nl_inv]), _nm(v.qNx[..., lf_inv]), v.s12[..., lf_inv],
        v.s13[..., lf_inv], _nm(v.cxN[..., lf_inv]),
    ]
    if v.pnl is not None:
        parts.append(_nm(v.pnl[..., nl_inv]))
    if v.plf is not None:
        parts.append(_nm(v.plf[..., lf_inv]))
    return _flat(parts)


def dual_from_ref(meta: ProblemMeta, vf) -> Dual:
    t = meta.tree
    nl, n, lf = t.n_nonleaf, t.n, t.n_leaf
    seg = _segments(vf, [nl * meta.ny, nl, (n - 1) * meta.nx,
                         (n - 1) * meta.nu, n - 1, n - 1,
                         nl * (meta.nx + meta.nu), lf * meta.nx, lf, lf,
                         lf * meta.nx])
    _, (all_fwd, nl_fwd, nr_fwd) = _perms(meta)
    lf_fwd = all_fwd[t.leaf_start:] - t.leaf_start
    v7 = _fm(seg[6], nl, meta.nx + meta.nu)[..., nl_fwd]
    return Dual(
        y=_fm(seg[0], nl, meta.ny)[..., nl_fwd],
        sby=seg[1][..., nl_fwd],
        qx=_fm(seg[2], n - 1, meta.nx)[..., nr_fwd],
        ru=_fm(seg[3], n - 1, meta.nu)[..., nr_fwd],
        t5=seg[4][..., nr_fwd],
        t6=seg[5][..., nr_fwd],
        cx=v7[..., : meta.nx, :],
        cu=v7[..., meta.nx:, :],
        qNx=_fm(seg[7], lf, meta.nx)[..., lf_fwd],
        s12=seg[8][..., lf_fwd],
        s13=seg[9][..., lf_fwd],
        cxN=_fm(seg[10], lf, meta.nx)[..., lf_fwd],
    )
