"""The whole-iteration SuperMann step: one CUDA kernel launch per iteration,
and one more for all of its backtracking retrials, which runs only what a
retrial changes.

The counterpart of the JAX package's ``spock_tpu/ops/pallas_spstep.py`` (and
of its lane-tiled predecessor ``pallas_spstep_lt.py``, whose function is this
one at tau = 1).  ``sp_step_fused`` runs, per lane, in one launch of
``csrc/sp_step.cu``: the fresh CP sweep at (z, v) unless the lane's cache
holds it, the residual and the Anderson window-3 direction, the candidate
sweep at (z, v) + tau d, and the K1 / K2 / fallback choice with the new
iterate.  It also returns a :class:`StepKeep`: the lane's zbar (as the
cache pair, the fresh-sweep pair and a flag), the direction d and the
scalars of phases 1-2.  ``sp_step_backtrack`` is the iteration's geometric
backtracking in one launch of B blocks: a lane that the tau = 1 launch
left looping makes its trials at tau = beta, beta^2, ... (up to
``max_backtracks``) in its block and stops at the first acceptance; z has
not moved, so a trial runs the candidate sweep and the commit on the kept
zbar and d alone, and writes z_new and s in place at that lane.  A trial
equals ``sp_step_fused`` with no cache at its tau on that lane (exactly
when the tau = 1 launch swept afresh; up to rounding when it read a valid
cache, which holds the sweep at (z, v)).  Which lanes loop is read on the
device: the launch needs no host sync, so a CUDA graph can hold it.

Pairs are the port's ``(Primal, Dual)`` with the 19 contiguous [B, rows,
cols] blocks of ``sweep_kernels.pair_shapes`` (the two polytope blocks None
when the problem has none).  The problem class is the JAX step kernels':
that of the sweep kernels with uniform costs (``supported``).  Each kernel
has two instances, one per sweep body, chosen by the problem's class
(``step_body``, the rule of ``sweep_kernels.sweep_body``): the node body
where nx, nu, ny + 2 d and the polytope rows of a node are at most 32 and
its shared-memory plan fits, the element body otherwise.  The JAX
kernel's W/Y/S lane packing exists only for the TPU's (8, 128) tiling and
has no counterpart here: a pair is passed as it is, and the root input is
``z.u[:, :, 0]``.

The [B, 10] scalar pack and the [B, 16] output scalars keep the JAX kernel's
slot numbers (``SC_*`` and ``OC_*``; the backtrack adds its trials in slot
``OC_TRIALS``).  The wrappers take their plain versions, ``sp_step_ref``
and ``sp_backtrack_ref`` (a loop of the one-trial ``sp_retrial_ref``), only
for tensors that lie on the CPU; for CUDA tensors they launch their kernel
or raise.  ``LAUNCHES`` counts the kernel launches of each, and of
csrc/sp_step.cu by body (``sp_step_node_body``, ``sp_step_element_body``:
both wrappers' launches), and
``RETRIALS`` holds, per device, the lanes that backtracked and the trials
they made, summed on the device (``retrials`` reads them), and the step
kernels' phase clock: while its flag is on (``set_phase_timing``), thread 0
of every block adds the ``clock64`` cycles of each part of the block's
work to the slots of ``PHASES`` (``phase_cycles`` reads them).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Any

import torch

from ..problem import ProblemData, ProblemMeta
from ..utils import profiling
from . import _build, sweep_kernels

LAUNCHES = {"sp_step_fused": 0, "sp_step_backtrack": 0,
            "sp_step_node_body": 0, "sp_step_element_body": 0}
# The cycle slots of the phase clock (csrc/sp_step.cu's kSlot*), summed over
# the blocks of every launch while the clock is on: the five parts of a
# sweep (every sweep a launch runs: fresh, candidate, each trial), phase 2
# (the Anderson pass), phase 4 and each trial's commit, and a block's cycles
# from its first statement to its last.
PHASES = ("lprime_s2", "riccati_backward", "riccati_forward", "prox_hconj",
          "metric", "anderson", "commit", "block_total")
# device -> int64 [3 + len(PHASES)], made once per device and zeroed in
# place (a CUDA graph holds its address): [0:2] the lanes that backtracked
# and the trials they made, added to by the backtrack (on the card by its
# kernel, with atomics); [2] the phase clock's flag; [3:] its cycle slots,
# added to by both step kernels while the flag is on
RETRIALS: dict = {}
_FLAG = 2
# bytes of the phase clock's words at the end of a step kernel's dynamic
# shared memory (csrc/sweep_body.cuh's kClockBytes)
CLOCK_BYTES = 96
# device -> the phase clock's flag as last written (no read of the card)
_TIMING: dict = {}

# scalar-pack slots (pallas_spstep.py's _SC_*)
SC_ACTIVE, SC_VALID1, SC_VALID2, SC_CACHE = 0, 1, 2, 3
SC_RSAFE, SC_QPOW, SC_RNC, SC_NMZC, SC_NMVC = 4, 5, 6, 7, 8
SC_TAU = 9
N_SC = 10
# output-scalar slots (pallas_spstep.py's _OC_*); slots 13-15 are zero
OC_K1, OC_K2, OC_LOOP, OC_RN, OC_RT, OC_RSAFE = 0, 1, 2, 3, 4, 5
OC_XI1, OC_XI2, OC_NMRWZ, OC_NMRWV = 6, 7, 8, 9
OC_G0, OC_G1, OC_G2 = 10, 11, 12
OC_TRIALS = 13  # the backtrack's trials made at a lane
N_OC = 16
# kept-scalar slots (csrc/sp_step.cu's KP_*): ||r||_M and the inf-norms of
# M r at (z, v), the Anderson weights, the cache flag; slot 7 is zero
KP_RN, KP_NMZ, KP_NMV, KP_G0, KP_G1, KP_G2, KP_CACHED = range(7)
N_KEEP = 8

_ARGTYPES = {
    "sp_step": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "sp_backtrack": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p],
}


def retrial_counts(device) -> torch.Tensor:
    """The counter of ``device`` (lanes that backtracked, trials made, the
    phase clock's flag and cycles), made zero on first use.  Raises if that
    use is inside a CUDA graph capture: the counter must outlive every graph
    that adds to it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    acc = RETRIALS.get(device)
    if acc is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the retrial counter of a device is made "
                               "outside a CUDA graph capture")
        acc = RETRIALS[device] = torch.zeros(3 + len(PHASES),
                                             dtype=torch.int64, device=device)
        _TIMING[device] = False
    return acc


def retrials() -> tuple:
    """(lanes that backtracked, trials made) summed over the devices since
    the last ``reset_retrials``; reads the counters (a host sync)."""
    tot = [0, 0]
    for acc in RETRIALS.values():
        lanes, trials = acc[:_FLAG].tolist()
        tot[0] += lanes
        tot[1] += trials
    return tuple(tot)


def reset_retrials() -> None:
    """Zero every device's retrials and phase cycles in place (the phase
    clock's flag stays)."""
    for acc in RETRIALS.values():
        acc[:_FLAG].zero_()
        acc[_FLAG + 1:].zero_()


def set_phase_timing(device, on: bool) -> None:
    """Turn the phase clock of ``device``'s step kernels on or off: a write
    on the device's stream where the flag changes, read by every later
    launch (and by the launches of graphs captured before).  Each launch of
    the wrappers sets it to whether a profiler records; a farm of graphs
    sets it before its replays.  No-op for the CPU and inside a CUDA graph
    capture (a graph must not write the flag)."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    acc = retrial_counts(device)
    device = acc.device
    if (_TIMING[device] != bool(on)
            and not torch.cuda.is_current_stream_capturing()):
        acc[_FLAG].fill_(int(bool(on)))
        _TIMING[device] = bool(on)


def phase_cycles():
    """{slot of ``PHASES``: cycles} summed over the cards' counters since
    the last ``reset_retrials`` (a host sync); None without a card's
    counter."""
    cards = [acc for d, acc in RETRIALS.items() if d.type == "cuda"]
    if not cards:
        return None
    tot = [0] * len(PHASES)
    for acc in cards:
        for k, v in enumerate(acc[_FLAG + 1:].tolist()):
            tot[k] += v
    return dict(zip(PHASES, tot))


@dataclasses.dataclass(frozen=True)
class StepKeep:
    """What a tau = 1 step keeps for the retrials of its iteration: the
    lane's zbar is ``cache`` where ``scal[:, KP_CACHED]`` is set and
    ``fresh`` elsewhere; ``d`` is the direction; ``scal`` [B, 8] holds the
    ``KP_*`` slots."""

    cache: Any  # (Primal, Dual): the cache pair the step read
    fresh: Any  # (Primal, Dual): the fresh sweep (on lanes without a cache)
    d: Any  # (Primal, Dual)
    scal: Any  # [B, N_KEEP]


def supported(meta: ProblemMeta, data: ProblemData) -> bool:
    """The class of the JAX package's ``pallas_spstep.supported`` without its
    VMEM terms: the sweep kernels' class (per-node risk and polytope rows
    included, at any width) with uniform costs; problems with per-node costs
    take the sweep kernels instead, as in the JAX package."""
    return (sweep_kernels.supported(meta, data)
            and all(a.shape[0] == 1 for a in (data.sqrtQ, data.sqrtR,
                                              data.sqrtQN)))


def step_body(meta: ProblemMeta, data: ProblemData, dtype) -> str:
    """The instance of csrc/sp_step.cu that runs the problem, by its class
    (the rule of ``sweep_kernels.sweep_body``): ``"node"`` where the node
    body's shared-memory plan fits with the phase clock's words,
    ``"element"`` otherwise.  Raises on a problem outside the step kernels'
    class."""
    if not supported(meta, data):
        raise ValueError("step kernels: unsupported problem class")
    plan = sweep_kernels.node_plan(meta, data, torch.finfo(dtype).bits // 8,
                                   tail=CLOCK_BYTES)
    return sweep_kernels.ELEMENT if plan is None else sweep_kernels.NODE


def _decide(pair, zbar, d, wbar, tau, act, rn, nmz, nmv, r_safe, q_pow,
            cand, gam, s_prev, gamma, sigma, c1, sigma_k2, lam, lam_sp):
    """Phase 4 of the plain versions: the K1 / K2 / fallback choice at the
    candidate sweep ``cand`` (rtsq, nmrwz, nmrwv, rho_dot, nmdz, nmdv), the
    new iterate, s_new (s_prev on an inactive lane; None when every lane is
    active) and the [B, 16] output scalars."""
    from ..algorithms.common import bexpand, bwhere
    from ..zv import sub, tmap

    rtsq, nmrwz, nmrwv, rho_dot, nmdz, nmdv = cand
    rtsq = torch.clamp(rtsq, min=0.0)
    rt = torch.sqrt(rtsq)
    k1 = act & (rn <= r_safe) & (rt <= c1 * rn)
    rho = rtsq - tau * rho_dot
    k2 = act & ~k1 & (rho >= sigma_k2 * rn * rt)
    pos = rtsq > 0
    coef = lam_sp * torch.where(
        pos, rho / torch.where(pos, rtsq, torch.ones_like(rtsq)),
        torch.zeros_like(rho))
    looping = act & ~k1 & ~k2
    w = tmap(lambda a, b: a + bexpand(tau, a) * b, pair, d)
    z_k2 = tmap(lambda a, b, c: a - bexpand(coef, a) * (b - c), pair, w, wbar)
    z_fb = zbar if lam == 1.0 else tmap(
        lambda a, b: lam * a + (1.0 - lam) * b, zbar, pair)
    z_new = bwhere(act, bwhere(k1, w, bwhere(k2, z_k2, z_fb)), pair)
    s_new = sub(z_new, pair)
    if s_prev is not None:
        s_new = bwhere(act, s_new, s_prev)

    xi1 = torch.where(k1, tau * nmdz / gamma,
                      torch.where(k2, coef * nmrwz / gamma, lam * nmz / gamma))
    xi2 = torch.where(k1, tau * nmdv / sigma,
                      torch.where(k2, coef * nmrwv / sigma, lam * nmv / sigma))
    out = torch.zeros((tau.shape[0], N_OC), dtype=tau.dtype,
                      device=tau.device)
    for slot, val in ((OC_K1, k1), (OC_K2, k2), (OC_LOOP, looping),
                      (OC_RN, rn), (OC_RT, rt),
                      (OC_RSAFE, torch.where(k1, rt + q_pow, r_safe)),
                      (OC_XI1, xi1), (OC_XI2, xi2), (OC_NMRWZ, nmrwz),
                      (OC_NMRWV, nmrwv), (OC_G0, gam[0]), (OC_G1, gam[1]),
                      (OC_G2, gam[2])):
        out[:, slot] = val.to(out.dtype)
    return z_new, s_new, out


def sp_step_ref(data: ProblemData, meta: ProblemMeta, z, v, cache, r_prev,
                s_prev, mr_a1, mr_a2, mp_a1, mp_a2, x0, scal, gamma, sigma,
                c1: float, sigma_k2: float, lam: float, lam_sp: float):
    """The plain PyTorch version of :func:`sp_step_fused`: the sweeps of
    ``common.cp_sweep_metric_ref`` and ``candidate_sweep_ref`` and tensor
    operations, with the same per-lane cache select."""
    from ..algorithms import anderson, common  # common imports this package
    from ..zv import sub, tmap, vdot

    bexpand, bwhere = common.bexpand, common.bwhere
    act = scal[:, SC_ACTIVE] > 0
    hp, v2 = scal[:, SC_VALID1], scal[:, SC_VALID2]
    cached = scal[:, SC_CACHE] > 0
    tau = scal[:, SC_TAU]
    pair = (z, v)

    # phase 1: the fresh sweep, taken where a lane has no valid cache (it is
    # computed for every lane: no host sync, so the timing on the card holds
    # no host time)
    zb, vb, _, _, rnsq, nmz_f, nmv_f = common.cp_sweep_metric_ref(
        data, meta, z, v, gamma, sigma, x0)
    zbar = bwhere(cached, cache, (zb, vb))
    rn_f = torch.sqrt(torch.clamp(rnsq, min=0.0))
    rn = torch.where(cached, scal[:, SC_RNC], rn_f)
    nmz = torch.where(cached, scal[:, SC_NMZC], nmz_f)
    nmv = torch.where(cached, scal[:, SC_NMVC], nmv_f)

    # phase 2: residual, new Anderson rows, window-3 direction
    r = sub(pair, zbar)
    y = tmap(lambda a, b: a - bexpand(hp, a) * b, r, r_prev)
    p = tmap(lambda a, b: bexpand(hp, a) * a - b, s_prev, y)
    r_next = bwhere(act, r, r_prev)
    rows = (y, mr_a1, mr_a2)
    valid = torch.stack([torch.ones_like(hp), hp, v2], dim=-1)  # [B, 3]
    G = torch.stack([torch.stack([vdot(a, b, 1) for b in rows], dim=-1)
                     for a in rows], dim=-2)
    G = G * (valid[:, :, None] * valid[:, None, :])
    cvec = torch.stack([vdot(a, r, 1) for a in rows], dim=-1) * valid
    tr = G[:, 0, 0] + G[:, 1, 1] + G[:, 2, 2]
    eps = 1e-10 * (tr / 3.0) + 1e-30
    eye = torch.eye(3, dtype=G.dtype, device=G.device)
    gam = anderson._solve3(G + eps[:, None, None] * eye, cvec) * valid
    g0, g1, g2 = gam[:, 0], gam[:, 1], gam[:, 2]
    d = tmap(lambda a, b, c, e: (-a - bexpand(g0, a) * b
                                 - bexpand(g1, a) * c
                                 - bexpand(g2, a) * e),
             r, p, mp_a1, mp_a2)

    # phase 3: the candidate sweep at (z, v) + tau d
    (wbar, ubar, _, _, *cand) = common.candidate_sweep_ref(
        data, meta, z, v, d[0], d[1], tau, gamma, sigma, x0)

    # phase 4: K1 / K2 / fallback and the new iterate
    z_new, s_new, out = _decide(
        pair, zbar, d, (wbar, ubar), tau, act, rn, nmz, nmv,
        scal[:, SC_RSAFE], scal[:, SC_QPOW], cand, (g0, g1, g2), s_prev,
        gamma, sigma, c1, sigma_k2, lam, lam_sp)
    kscal = torch.zeros((tau.shape[0], N_KEEP), dtype=tau.dtype,
                        device=tau.device)
    for slot, val in ((KP_RN, rn), (KP_NMZ, nmz), (KP_NMV, nmv),
                      (KP_G0, g0), (KP_G1, g1), (KP_G2, g2),
                      (KP_CACHED, cached)):
        kscal[:, slot] = val.to(kscal.dtype)
    return (z_new, (wbar, ubar), r_next, s_new, y, p, out,
            StepKeep(cache=cache, fresh=(zb, vb), d=d, scal=kscal))


def sp_retrial_ref(data: ProblemData, meta: ProblemMeta, z, v,
                   keep: "StepKeep", x0, scal, lanes, z_new, s, gamma, sigma,
                   c1: float, sigma_k2: float, lam: float, lam_sp: float):
    """One backtracking trial of the listed lanes (``lanes`` [k], distinct)
    at the tau of their rows of ``scal``, the building block of
    :func:`sp_backtrack_ref`: ``candidate_sweep_ref`` and the phase-4 commit
    of :func:`sp_step_ref` on the kept zbar and d, with z_new and s written
    at those lanes.  Returns the [k, 16] output scalars of the listed
    lanes, in their order."""
    from ..algorithms import common
    from ..zv import tmap

    def at(a):
        return a[lanes]

    cached = keep.scal[lanes, KP_CACHED] > 0
    pair = tmap(at, (z, v))
    d = tmap(at, keep.d)
    zbar = common.bwhere(cached, tmap(at, keep.cache), tmap(at, keep.fresh))
    sc, ks = scal[lanes], keep.scal[lanes]
    tau = sc[:, SC_TAU]
    (wbar, ubar, _, _, *cand) = common.candidate_sweep_ref(
        data, meta, *pair, *d, tau, gamma, sigma, x0[lanes])
    act = torch.ones_like(cached)
    zn, sn, out = _decide(
        pair, zbar, d, (wbar, ubar), tau, act, ks[:, KP_RN], ks[:, KP_NMZ],
        ks[:, KP_NMV], sc[:, SC_RSAFE], sc[:, SC_QPOW], cand,
        (ks[:, KP_G0], ks[:, KP_G1], ks[:, KP_G2]), None, gamma, sigma, c1,
        sigma_k2, lam, lam_sp)

    def put(dst, src):
        dst[lanes] = src

    tmap(put, z_new, zn)
    tmap(put, s, sn)
    return out


def sp_backtrack_ref(data: ProblemData, meta: ProblemMeta, z, v,
                     keep: "StepKeep", x0, scal, oscal, z_new, s, gamma,
                     sigma, beta: float, max_backtracks: int, c1: float,
                     sigma_k2: float, lam: float, lam_sp: float):
    """The plain PyTorch version of :func:`sp_step_backtrack`: the lanes
    that ``oscal`` (the tau = 1 step's output scalars) leaves looping take
    :func:`sp_retrial_ref` at tau = beta, beta^2, ... until they accept or
    have made ``max_backtracks`` trials.  Returns the [B, 16] output
    scalars (the last trial's at a looping lane, ``oscal``'s elsewhere;
    trials in slot OC_TRIALS) and the trials of each lane [B]."""
    B = oscal.shape[0]
    out = oscal.clone()
    looping = oscal[:, OC_LOOP] > 0.5
    tau = torch.full((B,), beta, dtype=oscal.dtype, device=oscal.device)
    trials = torch.zeros((B,), dtype=torch.int64, device=oscal.device)
    sc = scal.clone()
    for _ in range(max_backtracks):
        lanes = torch.nonzero(looping).flatten()
        if lanes.numel() == 0:
            break
        sc[:, SC_TAU] = tau
        out[lanes] = sp_retrial_ref(data, meta, z, v, keep, x0, sc, lanes,
                                    z_new, s, gamma, sigma, c1, sigma_k2,
                                    lam, lam_sp)
        trials[lanes] += 1
        looping = looping.index_copy(0, lanes, out[lanes, OC_LOOP] > 0.5)
        tau = torch.where(looping, tau * beta, tau)
    out[:, OC_TRIALS] = trials.to(out.dtype)
    return out, trials


def _empty_pair(sizes, shapes, dtype, device) -> list:
    """The 19 blocks of a pair as views of one allocation (None for an
    absent block)."""
    flat = torch.empty(sum(sizes), dtype=dtype, device=device)
    return [None if s is None else a.view(s)
            for a, s in zip(flat.split(sizes), shapes)]


def _scratch(body: str, meta: ProblemMeta, k: int, dtype, device) -> tuple:
    """The scratch of ``k`` blocks of the ``body`` instance: (the node
    instance's dvec and costates, the element instance's four arrays of
    ``sweep_kernels.element_scratch``), None for the other instance's.  The
    node instance's are [k, n_nl, ldu] and [k, (n_lf + mmax) ldx] values,
    with ldx, ldu nx, nu rounded up to a multiple of 4 (csrc/step_body.cuh's
    plan_smem); its costates are used only when they do not fit in shared
    memory."""
    if body == sweep_kernels.ELEMENT:
        return [None, None], sweep_kernels.element_scratch(meta, k, dtype,
                                                           device)
    t = meta.tree

    def pad4(n):
        return (n + 3) // 4 * 4

    qsize = (t.n_leaf + t.stage_size(t.N - 2)) * pad4(meta.nx)
    return [torch.empty(k * n, dtype=dtype, device=device)
            for n in (t.n_nonleaf * pad4(meta.nu), qsize)], [None] * 4


def _launch(name, entry, dtype, device, ptr, data, meta, coefs, body, count,
            *extra):
    """Launch the ``body`` instance of ``entry`` of csrc/sp_step.cu on
    ``count`` blocks (``extra``: its int arguments after the count); raise
    on a CUDA error."""
    on = profiling.recording()
    if _TIMING.get(device) != on:
        # the phase clock times the launches a profiler records, and no other
        set_phase_timing(device, on)
    ptrs = (ctypes.c_void_p * len(ptr))(*ptr)
    dims = sweep_kernels._dims(data, meta, True)
    cf = (ctypes.c_double * len(coefs))(*(float(c) for c in coefs))
    suffix = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    fn = getattr(_build.library("sp_step"), f"{entry}_{suffix}")
    fn.argtypes = _ARGTYPES[entry]
    fn.restype = ctypes.c_int
    rc = sweep_kernels._call(fn, (ctypes.addressof(ptrs),
                                  ctypes.addressof(dims),
                                  ctypes.addressof(cf),
                                  sweep_kernels.BODY_CODE[body], count,
                                  *extra),
                             device)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    sweep_kernels.count(LAUNCHES, name, f"sp_step_{body}_body")


def smem_plan(data: ProblemData, meta: ProblemMeta, dtype) -> dict:
    """The node instance's dynamic shared memory per block for values of
    ``dtype``, from csrc/sp_step.cu's own planner (builds the library):
    {bytes, costates_in_shared_memory, riccati_groups}.  Raises if no
    layout fits."""
    fn = _build.library("sp_step").sp_step_plan
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dims = sweep_kernels._dims(data, meta, True)
    out = (ctypes.c_int * 4)()
    if fn(ctypes.addressof(dims), torch.finfo(dtype).bits // 8,
          ctypes.addressof(out)) != 0:
        raise ValueError("the step kernels' shared-memory plan does not fit")
    return dict(bytes=out[0], costates_in_shared_memory=bool(out[1]),
                riccati_groups=out[2])


def _check_pairs(name, pairs, shapes, device, dtype) -> list:
    blocks = []
    for q in pairs:
        b = sweep_kernels._blocks(*q)
        sweep_kernels._check(name, b, shapes, device, dtype)
        blocks += b
    return blocks


def sp_step_fused(data: ProblemData, meta: ProblemMeta, z, v, cache, r_prev,
                  s_prev, mr_a1, mr_a2, mp_a1, mp_a2, x0, scal, gamma, sigma,
                  c1: float, sigma_k2: float, lam: float, lam_sp: float):
    """One SuperMann iteration of every lane in one launch.

    z, v: the iterate; cache, r_prev, s_prev, mr_a1, mr_a2 (the MR rows of
    age 1 and 2), mp_a1, mp_a2: (Primal, Dual) pairs; x0 [B, nx]; scal
    [B, 10] (``SC_*`` slots).  Returns ``(z_new, w, r, s, y, p, out_scal,
    keep)``: six pairs (the new iterate, the candidate's sweep = the next
    cache, the next r_prev and s_prev, the new Anderson rows), [B, 16]
    scalars (``OC_*`` slots) and the :class:`StepKeep` that
    :func:`sp_step_backtrack` takes."""
    name = "sp_step_fused"
    pairs = [(z, v), cache, r_prev, s_prev, mr_a1, mr_a2, mp_a1, mp_a2]
    if sweep_kernels._on_cpu(*(q[0].s for q in pairs), x0, scal):
        return sp_step_ref(data, meta, z, v, cache, r_prev, s_prev, mr_a1,
                           mr_a2, mp_a1, mp_a2, x0, scal, gamma, sigma, c1,
                           sigma_k2, lam, lam_sp)
    if not supported(meta, data):
        raise ValueError(f"{name} kernel: unsupported problem class")
    device, dtype, B, shapes, ins, consts = sweep_kernels._inputs(
        name, data, meta, z, v)
    body = step_body(meta, data, dtype)
    ins += _check_pairs(name, pairs[1:], shapes, device, dtype)
    sweep_kernels._check(name, [x0, scal], [(B, meta.nx), (B, N_SC)], device,
                         dtype)
    sizes = [0 if s is None else math.prod(s) for s in shapes]
    # six outputs, then the kept fresh-sweep and direction pairs
    outs = [_empty_pair(sizes, shapes, dtype, device) for _ in range(8)]
    oscal = torch.empty((B, N_OC), dtype=dtype, device=device)
    kscal = torch.empty((B, N_KEEP), dtype=dtype, device=device)
    scratch, elem = _scratch(body, meta, B, dtype, device)
    ptr = ([sweep_kernels._ptr(a) for a in ins]
           + [sweep_kernels._ptr(a) for pair in outs for a in pair]
           + [x0.data_ptr(), scal.data_ptr(), oscal.data_ptr(),
              kscal.data_ptr()]
           + [sweep_kernels._ptr(a) for a in scratch]
           + [retrial_counts(device).data_ptr()]
           + [sweep_kernels._ptr(a) for a in consts + elem])
    _launch(name, "sp_step", dtype, device, ptr, data, meta,
            (gamma, sigma, c1, sigma_k2, lam, lam_sp), body, B)
    res = tuple(sweep_kernels._pair(o) for o in outs)
    return (*res[:6], oscal, StepKeep(cache=cache, fresh=res[6], d=res[7],
                                      scal=kscal))


def sp_step_backtrack(data: ProblemData, meta: ProblemMeta, z, v,
                      keep: StepKeep, x0, scal, oscal, z_new, s, gamma, sigma,
                      beta: float, max_backtracks: int, c1: float,
                      sigma_k2: float, lam: float, lam_sp: float):
    """The backtracking of every lane that the iteration's tau = 1 launch
    left looping, in one launch of B blocks.

    z, v, x0, scal and ``keep`` as given to and returned by the iteration's
    :func:`sp_step_fused`, oscal its [B, 16] output scalars (a lane loops
    where its OC_LOOP slot is set), z_new and s the pairs it returned,
    written in place at the looping lanes.  Each looping lane tries tau =
    beta, beta^2, ... with its r_safe and q_pow of ``scal`` until K1 or K2
    accepts or it has made ``max_backtracks`` trials.  Returns the [B, 16]
    output scalars: a looping lane's last trial's, with its trials in slot
    OC_TRIALS, and oscal's row elsewhere.  Adds the lanes that looped and
    their trials to ``retrial_counts``."""
    name = "sp_step_backtrack"
    if sweep_kernels._on_cpu(z.s, v.sby, x0, scal, oscal, keep.scal):
        out, trials = sp_backtrack_ref(
            data, meta, z, v, keep, x0, scal, oscal, z_new, s, gamma, sigma,
            beta, max_backtracks, c1, sigma_k2, lam, lam_sp)
        retrial_counts(oscal.device)[:_FLAG].add_(torch.stack(
            [(trials > 0).sum(), trials.sum()]))
        return out
    if not supported(meta, data):
        raise ValueError(f"{name} kernel: unsupported problem class")
    if max_backtracks < 0:
        raise ValueError(f"{name} kernel: max_backtracks < 0")
    device, dtype, B, shapes, ins, consts = sweep_kernels._inputs(
        name, data, meta, z, v)
    body = step_body(meta, data, dtype)
    ins += _check_pairs(name, [keep.cache, keep.fresh, keep.d, z_new, s],
                        shapes, device, dtype)
    sweep_kernels._check(name, [x0, scal, keep.scal, oscal],
                         [(B, meta.nx), (B, N_SC), (B, N_KEEP), (B, N_OC)],
                         device, dtype)
    sizes = [0 if a is None else math.prod(a) for a in shapes]
    wscratch = _empty_pair(sizes, shapes, dtype, device)
    out = torch.empty((B, N_OC), dtype=dtype, device=device)
    scratch, elem = _scratch(body, meta, B, dtype, device)
    counts = retrial_counts(device)
    ptr = ([sweep_kernels._ptr(a) for a in ins]
           + [sweep_kernels._ptr(a) for a in wscratch]
           + [x0.data_ptr(), scal.data_ptr(), keep.scal.data_ptr(),
              oscal.data_ptr(), out.data_ptr()]
           + [sweep_kernels._ptr(a) for a in scratch] + [counts.data_ptr()]
           + [sweep_kernels._ptr(a) for a in consts + elem])
    _launch(name, "sp_backtrack", dtype, device, ptr, data, meta,
            (gamma, sigma, c1, sigma_k2, lam, lam_sp, beta), body, B,
            max_backtracks)
    return out
