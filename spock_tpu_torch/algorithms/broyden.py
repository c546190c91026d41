"""Restarted (modified) Broyden quasi-Newton direction with Powell damping.

The port of ``spock_tpu/algorithms/broyden.py``, chosen with
``SuperMannOpts(direction="broyden")``.  The secant pair of an iteration is
s = z_k - z_{k-1} and ybar = r_k - r_{k-1}; every inner product is in the
SuperMann metric M ("Ps" = M s).  The history is a [B, max_k, K] ring per
buffer that restarts (clears logically) after max_k pushes, per lane.

Memory: three rings of max_k * (nz + nv) values per lane (29.6 MB per lane at
server_heat N=10 nx=nu=20 in float32 with max_k = 20), so Anderson (window 3)
is the direction for large batches.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

THETA_BAR = 0.5  # Powell damping threshold


@dataclasses.dataclass(frozen=True)
class BroydenState:
    S: Any  # [B, max_k, K] past s vectors
    St: Any  # [B, max_k, K] past damped stilde vectors
    Ps: Any  # [B, max_k, K] past M s vectors
    k: Any  # [B] int32 per-lane history length


def init(B: int, K: int, max_k: int, dtype, device) -> BroydenState:
    def z():
        return torch.zeros((B, max_k, K), dtype=dtype, device=device)

    return BroydenState(S=z(), St=z(), Ps=z(),
                        k=torch.zeros((B,), dtype=torch.int32, device=device))


def _safe(den):
    return torch.where(den.abs() > 0, den, torch.ones_like(den))


def direction(state: BroydenState, r_flat, s_flat, y_flat, ps_flat,
              max_k: int):
    """Returns (d_flat [B, K], new_state).

    r_flat: current residual; s_flat / y_flat: the secant pair; ps_flat: M s.
    """
    d = -r_flat
    st = y_flat
    for i in range(max_k):
        active = (i < state.k)[:, None]  # per-lane history length
        Ps_i, S_i, St_i = state.Ps[:, i], state.S[:, i], state.St[:, i]
        diff = S_i - St_i
        safe = _safe(torch.sum(Ps_i * St_i, dim=-1))
        dot_st = torch.sum(Ps_i * st, dim=-1) / safe
        dot_d = torch.sum(Ps_i * d, dim=-1) / safe
        st = torch.where(active, st + dot_st[:, None] * diff, st)
        d = torch.where(active, d + dot_d[:, None] * diff, d)

    # Powell damping
    num = torch.sum(st * ps_flat, dim=-1)
    den = torch.sum(s_flat * ps_flat, dim=-1)
    gamma = num / _safe(den)
    theta = torch.where(
        gamma.abs() >= THETA_BAR,
        torch.ones_like(gamma),
        torch.where(gamma == 0.0,
                    torch.full_like(gamma, 1.0 - THETA_BAR),
                    (1.0 - torch.sign(gamma) * THETA_BAR) / (1.0 - gamma)),
    )
    st = (1.0 - theta)[:, None] * s_flat + theta[:, None] * st

    coef = torch.sum(ps_flat * d, dim=-1) / _safe(
        torch.sum(ps_flat * st, dim=-1))
    d = d + coef[:, None] * (s_flat - st)

    # ring update with restart: push while k < max_k, else clear, per lane
    do_push = state.k < max_k
    idx = torch.where(do_push, state.k, 0)
    hot = ((torch.arange(max_k, device=idx.device)[None, :] == idx[:, None])
           & do_push[:, None])[:, :, None]  # [B, max_k, 1] row selector

    def set_row(buf, row):
        return torch.where(hot, row[:, None, :], buf)

    new_state = BroydenState(
        S=set_row(state.S, s_flat),
        St=set_row(state.St, st),
        Ps=set_row(state.Ps, ps_flat),
        k=torch.where(do_push, state.k + 1, 0).to(torch.int32),
    )
    return d, new_state
