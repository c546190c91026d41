"""Batched cone and box projections (cone/feature axis -2, node axis last).

Polyhedral kinds and the second-order cone; the exponential cone of the
JAX package is not ported yet.
"""

from __future__ import annotations

import torch

from ..risks import ConeSpec


def project_soc(v):
    """Projection onto the second-order cone {(t, x): ||x|| <= t}.

    v: [..., k, n] with t = v[..., 0, :] and x = v[..., 1:, :].
    """
    t = v[..., 0, :]
    x = v[..., 1:, :]
    xn = torch.sqrt(torch.sum(x * x, dim=-2))
    # inside (xn <= t) -> identity; polar (xn <= -t) -> 0;
    # else onto the boundary: (t, x) <- (t + xn)/(2 xn) * (xn, x).
    inside = xn <= t
    polar = xn <= -t
    safe_xn = torch.where(xn > 0, xn, torch.ones_like(xn))
    t_new = (t + xn) / 2.0
    x_new = (t_new / safe_xn)[..., None, :] * x
    zero = torch.zeros_like(t)
    t_out = torch.where(inside, t, torch.where(polar, zero, t_new))
    x_out = torch.where(
        inside[..., None, :], x,
        torch.where(polar[..., None, :], torch.zeros_like(x), x_new),
    )
    return torch.cat([t_out[..., None, :], x_out], dim=-2)


def project_box(v, lo, hi):
    """v: [..., f, n]; lo/hi: [f] per-feature bounds."""
    return torch.clamp(v, lo[:, None], hi[:, None])


def project_cone_product(v, spec: ConeSpec):
    """Project [..., ny, n] onto a product cone described by ``spec``
    (segments along axis -2)."""
    out = []
    off = 0
    for kind, dim in spec:
        seg = v[..., off: off + dim, :]
        if kind == "zero":
            out.append(torch.zeros_like(seg))
        elif kind == "nonneg":
            out.append(torch.clamp(seg, min=0.0))
        elif kind == "nonpos":
            out.append(torch.clamp(seg, max=0.0))
        elif kind == "reals":
            out.append(seg)
        elif kind == "soc":
            out.append(project_soc(seg))
        else:
            raise ValueError(f"Unsupported cone kind: {kind}")
        off += dim
    return torch.cat(out, dim=-2)
