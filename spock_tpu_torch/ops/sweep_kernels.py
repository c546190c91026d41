"""The whole-sweep CUDA kernels of the port, their wrappers and launch counts.

The counterpart of the JAX package's ``spock_tpu/ops/pallas_sweep.py``:

* ``cp_sweep_fused``, ``cp_sweep_metric_fused`` and ``candidate_sweep_fused``
  run one Chambolle-Pock sweep per lane in one launch of ``csrc/cp_sweep.cu``
  (L', prox_f with the S1 Riccati sweeps and the S2 projector, L and prox_h*),
  with the metric image of the residual and the SuperMann reductions when
  asked;
* ``metric_apply_fused`` applies the metric M in one launch of
  ``csrc/metric_apply.cu``.

They take the JAX functions' arguments and return the same tuples, for the
JAX kernels' whole problem class (``supported``): costs and risk data uniform
or per node, a polyhedral dual cone, with or without two-sided polytope rows.
Both kernels are bound by memory: they read each lane's iterate and write
their outputs once (126 MB per plain sweep at the headline size, 38 us at
3.35 TB/s).

A pair is 19 blocks in the kernels' order (``BLOCKS``: the Primal fields,
``DUAL_BLOCKS``, then the polytope rows ``pnl`` and ``plf``); an absent
polytope block is None here and a null pointer in the kernel.

A wrapper takes its plain version (``common.cp_sweep_ref``,
``cp_sweep_metric_ref``, ``candidate_sweep_ref`` and ``linop.metric_apply``)
only for tensors that lie on the CPU.  For CUDA tensors it launches the kernel
or raises; nothing falls back.  ``LAUNCHES`` counts each wrapper's kernel
launches, so that a run can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from ..problem import ProblemData, ProblemMeta
from ..zv import DUAL_BLOCKS, Dual, Primal
from . import _build, cuda_kernels
from .linop import metric_apply

LAUNCHES = {"cp_sweep_fused": 0, "cp_sweep_metric_fused": 0,
            "candidate_sweep_fused": 0, "metric_apply_fused": 0}

MAX_STAGES = 24  # kMaxStages of csrc/sweep_common.cuh
MAX_KER = 32  # kMaxKer of csrc/sweep_body.cuh: ny + 2 d
PRIMAL_BLOCKS = ("x", "u", "s", "tau", "y")
DUAL_ALL = DUAL_BLOCKS + ("pnl", "plf")
BLOCKS = PRIMAL_BLOCKS + DUAL_ALL  # the 19 blocks of csrc/sweep_common.cuh

_SIGNATURES = {
    "cp_sweep": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double,
                 ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p],
    "metric_apply": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double,
                     ctypes.c_double, ctypes.c_int, ctypes.c_void_p],
}
_CONSTS: dict = {}


def supported(meta: ProblemMeta, data: ProblemData) -> bool:
    """The class of the JAX package's ``pallas_sweep.supported`` without its
    VMEM terms: a polyhedral dual cone (here of at most 8 segments), risk
    data (b, ker_proj) uniform or per non-leaf node, sqrtQ and sqrtR uniform
    or per non-root node, sqrtQN uniform or per leaf, with or without
    polytope rows; and a tree of at most 24 stages with ny + 2 d <= 32."""
    t = meta.tree
    return (all(k in cuda_kernels.KIND for k, _ in meta.dual_cone)
            and len(meta.dual_cone) <= cuda_kernels.MAX_SEGMENTS
            and data.b.shape[0] in (1, t.n_nonleaf)
            and data.ker_proj.shape[0] == data.b.shape[0]
            and data.sqrtQ.shape[0] in (1, t.n - 1)
            and data.sqrtR.shape[0] in (1, t.n - 1)
            and data.sqrtQN.shape[0] in (1, t.n_leaf)
            and t.N <= MAX_STAGES and meta.ny + 2 * t.d <= MAX_KER)


def pair_shapes(meta: ProblemMeta, B: int) -> list:
    """The [B, ...] shapes of the 19 blocks of a (Primal, Dual) pair in the
    kernels' order (``BLOCKS``), None for an absent polytope block."""
    t = meta.tree
    primal = [(B, meta.nx, t.n), (B, meta.nu, t.n_nonleaf), (B, t.n),
              (B, t.n - 1), (B, meta.ny, t.n_nonleaf)]
    dual = cuda_kernels.block_shapes(meta, B)
    poly = [(B, meta.nc_nl, t.n_nonleaf) if meta.nc_nl else None,
            (B, meta.nc_lf, t.n_leaf) if meta.nc_lf else None]
    return primal + [dual[k] for k in DUAL_BLOCKS] + poly


def _blocks(z: Primal, v: Dual) -> list:
    return ([getattr(z, k) for k in PRIMAL_BLOCKS]
            + [getattr(v, k) for k in DUAL_ALL])


def _pair(outs: list):
    """(Primal, Dual) from the 19 blocks in the kernels' order (None for an
    absent polytope block)."""
    return (Primal(**dict(zip(PRIMAL_BLOCKS, outs[:5]))),
            Dual(**dict(zip(DUAL_ALL, outs[5:]))))


def new_pair(meta: ProblemMeta, B: int, make):
    """A (Primal, Dual) pair of [B, ...] blocks, ``make(shape)`` for each
    block the problem has."""
    return _pair([None if s is None else make(s)
                  for s in pair_shapes(meta, B)])


def _on_cpu(*tensors) -> bool:
    return all(a.device.type == "cpu" for a in tensors)


def _check(name, tensors, shapes, device, dtype) -> None:
    """Each tensor on ``device`` in ``dtype``, contiguous, of its shape; a
    None shape (an absent block) takes None only."""
    for i, (a, shape) in enumerate(zip(tensors, shapes)):
        if (a is None) != (shape is None):
            raise ValueError(f"{name} kernel: argument {i} is "
                             f"{'missing' if a is None else 'not expected'}")
        if a is None:
            continue
        if a.device != device or a.dtype != dtype:
            raise ValueError(f"{name} kernel: argument {i} is {a.dtype} on "
                             f"{a.device}, expected {dtype} on {device}")
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{name} kernel: argument {i} has shape "
                             f"{tuple(a.shape)}, expected {tuple(shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{name} kernel: argument {i} is not contiguous")


def _device(name, a) -> torch.device:
    if a.device.type != "cuda":
        raise ValueError(f"{name} kernel: tensors on {a.device}")
    if a.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name} kernel: dtype {a.dtype} not supported")
    return a.device


N_LMATS = 7  # the first constants, the matrices of L (make_lmats's order)


def _consts(data: ProblemData, meta: ProblemMeta) -> list:
    """The kernels' constants, contiguous, in csrc/sweep_body.cuh's
    make_consts order: sqrtQ, sqrtR, sqrtQN and b (whole, with their node
    dimension), the polytope rows Gx, Gu and GxN, ker_proj, the stage stacks
    of K, Rtinv, ABK and PB, B, the box bounds and the polytope bounds
    (None where the problem has no polytope)."""
    hit = _CONSTS.get(id(data))
    if hit is not None and hit[0] is data:
        return hit[1]
    ric = data.ric
    consts = [data.sqrtQ, data.sqrtR, data.sqrtQN, data.b,
              data.Gx, data.Gu, data.GxN, data.ker_proj,
              torch.stack([a[0] for a in ric.K]),
              torch.stack([a[0] for a in ric.Rtinv]),
              torch.stack([a[0] for a in ric.ABK]),
              torch.stack([a[0] for a in ric.PB]),
              data.B, data.x_min, data.x_max, data.u_min, data.u_max,
              data.p_lo, data.p_hi, data.pN_lo, data.pN_hi]
    consts = [None if a is None else a.contiguous() for a in consts]
    if len(_CONSTS) >= 8:
        _CONSTS.clear()
    _CONSTS[id(data)] = (data, consts)
    return consts


def _dims(data: ProblemData, meta: ProblemMeta, segments: bool):
    """The int array ``dims`` (csrc/sweep_common.cuh's Dim entries, then
    with ``segments`` the dual cone's row segments)."""
    t = meta.tree
    dims = [meta.nx, meta.nu, meta.ny, t.N, t.d, meta.nc_nl, meta.nc_lf]
    dims += [int(a.shape[0] != 1) for a in (data.sqrtQ, data.sqrtR,
                                            data.sqrtQN, data.b)]
    if segments:
        segs = cuda_kernels.cone_segments(meta.dual_cone)
        dims.append(len(segs))
        dims += [x for kind, lo, hi in segs
                 for x in (cuda_kernels.KIND[kind], lo, hi)]
    return (ctypes.c_int * len(dims))(*dims)


def _fn(lib: str, dtype: torch.dtype):
    suffix = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    fn = getattr(_build.library(lib), f"{lib}_{suffix}")
    fn.argtypes = _SIGNATURES[lib]
    fn.restype = ctypes.c_int
    return fn


def _call(fn, args, device) -> int:
    """Launch on the current stream of ``device``; returns the CUDA error."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        return fn(*args, stream)


def _ptr(a):
    return None if a is None else a.data_ptr()


def _inputs(name, data, meta, z, v):
    """Check the problem class and the (z, v) pair; returns (device, dtype,
    B, the 19 block shapes, the 19 blocks, the constants)."""
    if not supported(meta, data):
        raise ValueError(f"{name} kernel: unsupported problem class")
    device = _device(name, z.s)
    dtype = z.s.dtype
    B = z.s.shape[0]
    shapes = pair_shapes(meta, B)
    ins = _blocks(z, v)
    _check(name, ins, shapes, device, dtype)
    consts = _consts(data, meta)
    _check(name, consts, [None if a is None else tuple(a.shape)
                          for a in consts], device, dtype)
    return device, dtype, B, shapes, ins, consts


def _launch(name, lib, dtype, device, ptr, dims, *args) -> None:
    """Launch ``lib`` with the host array of device pointers ``ptr`` (None
    for unused ones) and the int array ``dims``; raise on a CUDA error."""
    ptrs = (ctypes.c_void_p * len(ptr))(*ptr)
    rc = _call(_fn(lib, dtype),
               (ctypes.addressof(ptrs), ctypes.addressof(dims), *args),
               device)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _empty(shapes, dtype, device) -> list:
    return [None if s is None else torch.empty(s, dtype=dtype, device=device)
            for s in shapes]


def _sweep(name, data, meta, z, v, gamma, sigma, x0, metric, direction=None):
    """Launch csrc/cp_sweep.cu; returns the output tensors (19 of zbar/vbar,
    then with ``metric`` 19 of M r and the [6, B] scalar rows)."""
    device, dtype, B, shapes, ins, consts = _inputs(name, data, meta, z, v)
    _check(name, [x0], [(B, meta.nx)], device, dtype)
    dirs, tau = [None] * len(BLOCKS), None
    if direction is not None:
        dz, dv, tau = direction
        dirs = _blocks(dz, dv)
        _check(name, dirs, shapes, device, dtype)
        tau = torch.as_tensor(tau, dtype=dtype, device=device)
        tau = tau.expand(B).contiguous() if tau.ndim == 0 else tau
        _check(name, [tau], [(B,)], device, dtype)
    t = meta.tree
    mmax = t.stage_size(t.N - 2)
    outs = _empty(shapes, dtype, device)
    mrs = _empty(shapes, dtype, device) if metric else [None] * len(BLOCKS)
    scal = torch.empty((6, B), dtype=dtype, device=device)
    scratch = [torch.empty((B, n), dtype=dtype, device=device) for n in (
        meta.nx * t.n, meta.nu * mmax, meta.nu * t.n_nonleaf,
        t.d * meta.nx * mmax)]
    ptr = [_ptr(a) for a in ins + dirs + outs + mrs + list(scal) + [x0, tau]
           + consts + scratch]
    _launch(name, "cp_sweep", dtype, device, ptr, _dims(data, meta, True),
            float(gamma), float(sigma), int(metric),
            int(direction is not None), B)
    return outs, mrs, scal


def cp_sweep_fused(data: ProblemData, meta: ProblemMeta, z: Primal, v: Dual,
                   gamma, sigma, x0):
    """One CP sweep in one launch; returns (zbar, vbar)."""
    if _on_cpu(z.s, v.sby, x0):
        from ..algorithms import common  # common imports this module
        return common.cp_sweep_ref(data, meta, z, v, gamma, sigma, x0)
    outs, _, _ = _sweep("cp_sweep_fused", data, meta, z, v, gamma, sigma, x0,
                        metric=False)
    return _pair(outs)


def cp_sweep_metric_fused(data: ProblemData, meta: ProblemMeta, z: Primal,
                          v: Dual, gamma, sigma, x0):
    """CP sweep, the metric image of its residual and the reductions in one
    launch; returns ``(zbar, vbar, Mrz, Mrv, rnorm_sq, nMrz, nMrv)``."""
    if _on_cpu(z.s, v.sby, x0):
        from ..algorithms import common
        return common.cp_sweep_metric_ref(data, meta, z, v, gamma, sigma, x0)
    outs, mrs, scal = _sweep("cp_sweep_metric_fused", data, meta, z, v,
                             gamma, sigma, x0, metric=True)
    return (*_pair(outs), *_pair(mrs), scal[0], scal[1], scal[2])


def candidate_sweep_fused(data: ProblemData, meta: ProblemMeta, z: Primal,
                          v: Dual, dz: Primal, dv: Dual, tau, gamma, sigma,
                          x0):
    """The SuperMann candidate at (z, v) + tau (dz, dv) in one launch;
    returns ``(wbar, ubar, Mrz, Mrv, rnorm_sq, nMrz, nMrv, rho_dot, nMdz,
    nMdv)``.  M d is never stored."""
    if _on_cpu(z.s, v.sby, dz.s, dv.sby, x0, torch.as_tensor(tau)):
        from ..algorithms import common
        return common.candidate_sweep_ref(data, meta, z, v, dz, dv, tau,
                                          gamma, sigma, x0)
    outs, mrs, scal = _sweep("candidate_sweep_fused", data, meta, z, v,
                             gamma, sigma, x0, metric=True,
                             direction=(dz, dv, tau))
    return (*_pair(outs), *_pair(mrs), *scal)


def metric_apply_fused(data: ProblemData, meta: ProblemMeta, z: Primal,
                       v: Dual, gamma, sigma):
    """M (z, v) in one launch; returns (Mz, Mv)."""
    name = "metric_apply_fused"
    if _on_cpu(z.s, v.sby):
        return metric_apply(data, meta, z, v, gamma, sigma)
    device, dtype, B, shapes, ins, consts = _inputs(name, data, meta, z, v)
    outs = _empty(shapes, dtype, device)
    ptr = [_ptr(a) for a in ins + outs + consts[:N_LMATS]]
    _launch(name, "metric_apply", dtype, device, ptr,
            _dims(data, meta, False),
            float(gamma), float(sigma), B)
    return _pair(outs)
