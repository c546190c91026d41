"""Batched cone and box projections (cone/feature axis -2, node axis last).

Polyhedral kinds, the second-order cone and the exponential cone (EVaR).
"""

from __future__ import annotations

import math

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


def _linspace(start, stop, num: int, like):
    """``jnp.linspace`` in the dtype and on the device of ``like``, computed
    as JAX computes it: start (1 - i/div) + stop i/div, the last point
    ``stop`` itself."""
    start = torch.as_tensor(start, dtype=like.dtype, device=like.device)
    stop = torch.as_tensor(stop, dtype=like.dtype, device=like.device)
    div = num - 1
    step = torch.arange(div, dtype=like.dtype, device=like.device) / div
    return torch.cat([start * (1 - step) + stop * step, stop[None]])


def _exp_boundary_candidate(r, s, t):
    """Best point on the boundary's ruled surface p(a, y) = (a y, y, y e^a),
    y >= 0: for each a the optimal y is closed form; a is minimised over a
    coarse grid, then refined by 40 golden-section steps.  Returns (x, y,
    z).  The grid's 57 points are evaluated in one broadcast, and the two
    points of a golden step in one: each element is computed as in the JAX
    package's loop."""

    def dist_at(a):
        ea = torch.exp(a)
        y = (r * a + s + t * ea) / (1.0 + a * a + ea * ea)
        y = torch.clamp(y, min=0.0)
        x, z = a * y, y * ea
        d = (x - r) ** 2 + (y - s) ** 2 + (z - t) ** 2
        return d, (x, y, z)

    # coarse grid over a = x/y (denser near 0, covering +-30)
    log30 = torch.log(torch.tensor(30.0, dtype=r.dtype, device=r.device))
    grid = torch.cat([-torch.exp(_linspace(log30, -3.0, 24, r)),
                      _linspace(-0.05, 0.05, 9, r),
                      torch.exp(_linspace(-3.0, log30, 24, r))])
    G = grid.shape[0]
    ds, _ = dist_at(grid.reshape((G,) + (1,) * r.ndim))  # [G, ...]
    # the first minimum, as jnp.argmin
    idx = torch.argmin(ds, dim=0)
    # golden-section refine in [grid[idx-1], grid[idx+1]]
    lo = grid[torch.clamp(idx - 1, 0, G - 1)]
    hi = grid[torch.clamp(idx + 1, 0, G - 1)]
    phi = 0.6180339887498949
    for _ in range(40):
        m1 = hi - phi * (hi - lo)
        m2 = lo + phi * (hi - lo)
        d12, _ = dist_at(torch.stack([m1, m2]))
        closer = d12[0] < d12[1]
        lo = torch.where(closer, lo, m1)
        hi = torch.where(closer, m2, hi)
    a = 0.5 * (lo + hi)
    _, (x, y, z) = dist_at(a)
    return x, y, z


def _project_exp_cone(v):
    """Projection onto the exponential cone
    K_exp = cl{(x,y,z): y > 0, y e^{x/y} <= z}; v: [..., 3, n].

    Cases:
      1. v in K_exp                      -> v
      2. -v in K_exp* (v in polar cone)  -> 0
      3. r <= 0 and s <= 0               -> face point (r, 0, max(t, 0))
      4. otherwise                       -> boundary solve (grid + golden)
    The boundary candidate and (where valid) the face candidate are compared
    and the closer one wins, which also guards case-boundary roundoff.
    """
    r, s, t = v[..., 0, :], v[..., 1, :], v[..., 2, :]
    one = torch.ones_like(s)

    safe_s = torch.where(s > 0, s, one)
    in_cone = ((s > 0) & (safe_s * torch.exp(r / safe_s) <= t)) | (
        (s <= 0) & (s >= -0.0) & (r <= 0) & (t >= 0))
    # polar: -v in K* = {(u,p,q): u<0, -u e^{p/u} <= e q} u {0} x R+ x R+.
    # The JAX package ORs in a second clause for the {0} x R+ x R+ part that
    # ends in "& False", so it never holds: left out here.
    safe_r = torch.where(r > 0, r, one)
    in_polar = ((r > 0) & (t <= 0)
                & (safe_r * torch.exp(s / safe_r) <= -math.e * t))

    # face candidate (valid whenever it is the projection: r<=0, s<=0 region)
    fx, fy, fz = r, torch.zeros_like(s), torch.clamp(t, min=0.0)
    face_valid = (r <= 0) & (s <= 0)
    face_d = (fx - r) ** 2 + s ** 2 + (fz - t) ** 2

    bx, by, bz = _exp_boundary_candidate(r, s, t)
    bdry_d = (bx - r) ** 2 + (by - s) ** 2 + (bz - t) ** 2

    use_face = face_valid & (face_d <= bdry_d)
    px = torch.where(use_face, fx, bx)
    py = torch.where(use_face, fy, by)
    pz = torch.where(use_face, fz, bz)

    out = torch.stack([px, py, pz], dim=-2)
    out = torch.where(in_polar[..., None, :], torch.zeros_like(out), out)
    return torch.where(in_cone[..., None, :], v, out)


def _project_exp_run(seg, dual: bool):
    """A run of k adjacent 3-row exponential-cone segments [..., 3k, n],
    projected as one [..., k, 3, n] batch onto K_exp, or onto its dual by
    Moreau: P_{K*}(v) = v + P_K(-v)."""
    shape = seg.shape
    v = seg.reshape(shape[:-2] + (shape[-2] // 3, 3, shape[-1]))
    p = v + _project_exp_cone(-v) if dual else _project_exp_cone(v)
    return p.reshape(shape)


def project_cone_product(v, spec: ConeSpec):
    """Project [..., ny, n] onto a product cone described by ``spec``
    (segments along axis -2).  Adjacent segments of one exponential kind
    are projected together."""
    out = []
    off = 0
    i = 0
    while i < len(spec):
        kind, dim = spec[i]
        i += 1
        if kind in ("exp", "exp_dual"):
            while i < len(spec) and spec[i][0] == kind:
                dim += spec[i][1]
                i += 1
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
        elif kind in ("exp", "exp_dual"):
            out.append(_project_exp_run(seg, kind == "exp_dual"))
        else:
            raise ValueError(f"Unsupported cone kind: {kind}")
        off += dim
    return torch.cat(out, dim=-2)
