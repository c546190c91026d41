"""Anderson acceleration (type II) direction for SuperMann.

Window-m history of residual differences ``dR`` and ``dP = dZ - dR``;
direction

    d = -r - dP^T gamma,   gamma = argmin || dR^T gamma - r ||_2,

by Tikhonov-regularized normal equations (a tiny m x m system per lane).
The histories are newest-first trees (row 0 = newest) whose leaves are
[B, m, *event].
"""

from __future__ import annotations

import torch

from ..zv import leaves, tmap


def _solve3(A, b):
    """Closed-form batched 3x3 solve via the adjugate (Cramer).
    A: [B, 3, 3], b: [B, 3].

    The system is first scaled to entries of magnitude <= 1 (the solution
    does not change): the adjugate multiplies three entries, and for the
    small Gram of a lane near convergence (one valid row and the 1e-10
    regularisation) the float32 determinant falls below the normal range,
    so 1 / det overflows and the direction becomes inf or NaN."""
    s = A.abs().amax(dim=(1, 2))
    s = torch.where(s > 0, s, torch.ones_like(s))
    A = A / s[:, None, None]
    b = b / s[:, None]
    a, bb, c = A[:, 0, 0], A[:, 0, 1], A[:, 0, 2]
    d, e, f = A[:, 1, 0], A[:, 1, 1], A[:, 1, 2]
    g, h, i = A[:, 2, 0], A[:, 2, 1], A[:, 2, 2]
    co00 = e * i - f * h
    co01 = f * g - d * i
    co02 = d * h - e * g
    det = a * co00 + bb * co01 + c * co02
    co10 = c * h - bb * i
    co11 = a * i - c * g
    co12 = bb * g - a * h
    co20 = bb * f - c * e
    co21 = c * d - a * f
    co22 = a * e - bb * d
    x0 = co00 * b[:, 0] + co10 * b[:, 1] + co20 * b[:, 2]
    x1 = co01 * b[:, 0] + co11 * b[:, 1] + co21 * b[:, 2]
    x2 = co02 * b[:, 0] + co12 * b[:, 1] + co22 * b[:, 2]
    inv = 1.0 / torch.where(det != 0, det, torch.ones_like(det))
    return torch.stack([x0, x1, x2], dim=-1) * inv[:, None]


def hist_insert(H, new):
    """Insert ``new`` as row 0 of a newest-first history, shifting older rows
    right (the oldest falls off).  H: leaves [B, m, *event]; new: leaves
    [B, *event].  The row order is the same for every lane at every
    iteration, so a lane refilled mid-farm sees exactly the history layout
    of a standalone warm-started solve."""
    return tmap(lambda h, nl: torch.cat([nl[:, None], h[:, :-1]], dim=1),
                H, new)


def direction_struct(MR, MP, r, niter):
    """Anderson direction over structured newest-first histories.

    MR/MP: trees with leaves [B, m, *event] (row 0 = newest); r: residual
    tree (leaves [B, *event]); niter: [B] iteration counter of each lane's
    current solve.

    Row j was inserted j iterations ago, so it belongs to the lane's current
    solve iff ``j <= niter``.  Older rows (left over from a previous solve
    after a farm refill) are excluded algebraically: their Gram entries and
    gamma weights are zeroed, exactly what physically zeroed rows would
    contribute, with no reset pass over the history.
    """
    mr_leaves, r_leaves = leaves(MR), leaves(r)
    B, m = mr_leaves[0].shape[:2]
    dtype, device = mr_leaves[0].dtype, mr_leaves[0].device

    # Gram G_ij = <y_i, y_j> and c_j = <y_j, r>, accumulated leafwise with
    # one batched product per leaf (the window is tiny, the leaves long).
    Gm = torch.zeros((B, m, m), dtype=dtype, device=device)
    cm = torch.zeros((B, m), dtype=dtype, device=device)
    for hl, rl in zip(mr_leaves, r_leaves):
        h = hl.reshape(B, m, -1)
        Gm = Gm + torch.bmm(h, h.transpose(1, 2))
        cm = cm + torch.bmm(h, rl.reshape(B, -1, 1))[..., 0]

    vm = (torch.arange(m, device=device)[None, :]
          <= niter[:, None]).to(dtype)  # [B, m]
    Gm = Gm * (vm[:, :, None] * vm[:, None, :])
    cm = cm * vm
    tr = torch.diagonal(Gm, dim1=-2, dim2=-1).sum(-1)
    eps = 1e-10 * (tr / m) + 1e-30
    Greg = Gm + eps[:, None, None] * torch.eye(m, dtype=dtype, device=device)
    if m == 3:
        gamma = _solve3(Greg, cm)
    else:
        gamma = torch.linalg.solve(Greg, cm[..., None])[..., 0]
    gamma = gamma * vm

    def comb(rl, pl):
        step = torch.bmm(gamma[:, None, :], pl.reshape(B, m, -1))
        return -rl - step.reshape(rl.shape)

    return tmap(comb, r, MP)
