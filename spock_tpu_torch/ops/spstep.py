"""The whole-iteration SuperMann step: one CUDA kernel launch per iteration.

The counterpart of the JAX package's ``spock_tpu/ops/pallas_spstep.py`` (and
of its lane-tiled predecessor ``pallas_spstep_lt.py``, whose function is this
one at tau = 1).  ``sp_step_fused`` runs, per lane, in one launch of
``csrc/sp_step.cu``: the fresh CP sweep at (z, v) unless the lane's cache
holds it, the residual and the Anderson window-3 direction, the candidate
sweep at (z, v) + tau d, and the K1 / K2 / fallback choice with the new
iterate.

Pairs are the port's ``(Primal, Dual)`` with the 19 contiguous [B, rows,
cols] blocks of ``sweep_kernels.pair_shapes`` (the two polytope blocks None
when the problem has none).  The problem class is the JAX step kernels':
that of the sweep kernels with uniform costs (``supported``).  The JAX kernel's W/Y/S lane
packing exists only for the TPU's (8, 128) tiling and has no counterpart
here: a pair is passed as it is, and the root input is ``z.u[:, :, 0]``.

The [B, 10] scalar pack and the [B, 16] output scalars keep the JAX kernel's
slot numbers (``SC_*`` and ``OC_*``).  The wrapper takes its plain version,
``sp_step_ref``, only for tensors that lie on the CPU; for CUDA tensors it
launches the kernel or raises.  ``LAUNCHES`` counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..problem import ProblemData, ProblemMeta
from . import _build, sweep_kernels

LAUNCHES = {"sp_step_fused": 0}

# scalar-pack slots (pallas_spstep.py's _SC_*)
SC_ACTIVE, SC_VALID1, SC_VALID2, SC_CACHE = 0, 1, 2, 3
SC_RSAFE, SC_QPOW, SC_RNC, SC_NMZC, SC_NMVC = 4, 5, 6, 7, 8
SC_TAU = 9
N_SC = 10
# output-scalar slots (pallas_spstep.py's _OC_*); slots 13-15 are zero
OC_K1, OC_K2, OC_LOOP, OC_RN, OC_RT, OC_RSAFE = 0, 1, 2, 3, 4, 5
OC_XI1, OC_XI2, OC_NMRWZ, OC_NMRWV = 6, 7, 8, 9
OC_G0, OC_G1, OC_G2 = 10, 11, 12
N_OC = 16

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p]


def supported(meta: ProblemMeta, data: ProblemData) -> bool:
    """The class of the JAX package's ``pallas_spstep.supported`` without its
    VMEM terms: the sweep kernels' class (per-node risk and polytope rows
    included) with uniform costs; per-node sqrtQ, sqrtR or sqrtQN take the
    sweep kernels instead."""
    return (sweep_kernels.supported(meta, data)
            and all(a.shape[0] == 1 for a in (data.sqrtQ, data.sqrtR,
                                              data.sqrtQN)))


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
    dz, dv = tmap(lambda a, b, c, e: (-a - bexpand(g0, a) * b
                                      - bexpand(g1, a) * c
                                      - bexpand(g2, a) * e),
                  r, p, mp_a1, mp_a2)

    # phase 3: the candidate sweep at (z, v) + tau d
    (wbar, ubar, _, _, rtsq, nmrwz, nmrwv, rho_dot, nmdz,
     nmdv) = common.candidate_sweep_ref(data, meta, z, v, dz, dv, tau, gamma,
                                        sigma, x0)

    # phase 4: K1 / K2 / fallback and the new iterate
    rtsq = torch.clamp(rtsq, min=0.0)
    rt = torch.sqrt(rtsq)
    r_safe = scal[:, SC_RSAFE]
    k1 = act & (rn <= r_safe) & (rt <= c1 * rn)
    rho = rtsq - tau * rho_dot
    k2 = act & ~k1 & (rho >= sigma_k2 * rn * rt)
    pos = rtsq > 0
    coef = lam_sp * torch.where(
        pos, rho / torch.where(pos, rtsq, torch.ones_like(rtsq)),
        torch.zeros_like(rho))
    looping = act & ~k1 & ~k2
    w = tmap(lambda a, b: a + bexpand(tau, a) * b, pair, (dz, dv))
    z_k2 = tmap(lambda a, b, c: a - bexpand(coef, a) * (b - c), pair, w,
                (wbar, ubar))
    z_fb = zbar if lam == 1.0 else tmap(
        lambda a, b: lam * a + (1.0 - lam) * b, zbar, pair)
    z_new = bwhere(act, bwhere(k1, w, bwhere(k2, z_k2, z_fb)), pair)
    s_new = bwhere(act, sub(z_new, pair), s_prev)

    xi1 = torch.where(k1, tau * nmdz / gamma,
                      torch.where(k2, coef * nmrwz / gamma, lam * nmz / gamma))
    xi2 = torch.where(k1, tau * nmdv / sigma,
                      torch.where(k2, coef * nmrwv / sigma, lam * nmv / sigma))
    out = torch.zeros((tau.shape[0], N_OC), dtype=tau.dtype,
                      device=tau.device)
    for slot, val in ((OC_K1, k1), (OC_K2, k2), (OC_LOOP, looping),
                      (OC_RN, rn), (OC_RT, rt),
                      (OC_RSAFE, torch.where(k1, rt + scal[:, SC_QPOW],
                                             r_safe)),
                      (OC_XI1, xi1), (OC_XI2, xi2), (OC_NMRWZ, nmrwz),
                      (OC_NMRWV, nmrwv), (OC_G0, g0), (OC_G1, g1),
                      (OC_G2, g2)):
        out[:, slot] = val.to(out.dtype)
    return z_new, (wbar, ubar), r_next, s_new, y, p, out


def _empty_pair(sizes, shapes, dtype, device) -> list:
    """The 19 blocks of a pair as views of one allocation (None for an
    absent block)."""
    flat = torch.empty(sum(sizes), dtype=dtype, device=device)
    return [None if s is None else a.view(s)
            for a, s in zip(flat.split(sizes), shapes)]


def _block_ptrs(flat, sizes) -> list:
    """Device pointers of consecutive blocks of ``sizes`` elements in the
    one-dimensional tensor ``flat`` (None for an empty block)."""
    ptrs, off = [], 0
    for n in sizes:
        ptrs.append(flat.data_ptr() + off * flat.element_size() if n
                    else None)
        off += n
    return ptrs


def sp_step_fused(data: ProblemData, meta: ProblemMeta, z, v, cache, r_prev,
                  s_prev, mr_a1, mr_a2, mp_a1, mp_a2, x0, scal, gamma, sigma,
                  c1: float, sigma_k2: float, lam: float, lam_sp: float):
    """One SuperMann iteration of every lane in one launch.

    z, v: the iterate; cache, r_prev, s_prev, mr_a1, mr_a2 (the MR rows of
    age 1 and 2), mp_a1, mp_a2: (Primal, Dual) pairs; x0 [B, nx]; scal
    [B, 10] (``SC_*`` slots).  Returns ``(z_new, w, r, s, y, p, out_scal)``:
    six pairs (the new iterate, the candidate's sweep = the next cache, the
    next r_prev and s_prev, the new Anderson rows) and [B, 16] scalars
    (``OC_*`` slots)."""
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
    for q in pairs[1:]:
        blocks = sweep_kernels._blocks(*q)
        sweep_kernels._check(name, blocks, shapes, device, dtype)
        ins += blocks
    sweep_kernels._check(name, [x0, scal], [(B, meta.nx), (B, N_SC)], device,
                         dtype)
    sizes = [0 if s is None else math.prod(s) for s in shapes]
    outs = [_empty_pair(sizes, shapes, dtype, device) for _ in range(6)]
    # scratch: the fresh-sweep and direction pairs, then the sweep's
    # costate and feedforward arrays
    t = meta.tree
    mmax = t.stage_size(t.N - 2)
    costates = [B * meta.nx * t.n, B * meta.nu * mmax,
                B * meta.nu * t.n_nonleaf, B * t.d * meta.nx * mmax]
    flat = torch.empty(2 * sum(sizes) + sum(costates), dtype=dtype,
                       device=device)
    scratch = _block_ptrs(flat, sizes * 2 + costates)
    oscal = torch.empty((B, N_OC), dtype=dtype, device=device)
    ptr = ([sweep_kernels._ptr(a) for a in ins]
           + [sweep_kernels._ptr(a) for pair in outs for a in pair]
           + scratch[:2 * len(sizes)]
           + [x0.data_ptr(), scal.data_ptr(), oscal.data_ptr()]
           + [sweep_kernels._ptr(a) for a in consts]
           + scratch[2 * len(sizes):])
    ptrs = (ctypes.c_void_p * len(ptr))(*ptr)
    dims = sweep_kernels._dims(data, meta, True)
    coefs = (ctypes.c_double * 6)(float(gamma), float(sigma), float(c1),
                                  float(sigma_k2), float(lam), float(lam_sp))
    suffix = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    fn = getattr(_build.library("sp_step"), f"sp_step_{suffix}")
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    rc = sweep_kernels._call(fn, (ctypes.addressof(ptrs),
                                  ctypes.addressof(dims),
                                  ctypes.addressof(coefs), B), device)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    return (*(sweep_kernels._pair(o) for o in outs), oscal)
