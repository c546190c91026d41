"""The whole-sweep CUDA kernels of the port, their wrappers and launch counts.

The counterpart of the JAX package's ``spock_tpu/ops/pallas_sweep.py``:

* ``cp_sweep_fused``, ``cp_sweep_metric_fused`` and ``candidate_sweep_fused``
  run one Chambolle-Pock sweep per lane in one launch of ``csrc/cp_sweep.cu``
  (L', prox_f with the S1 Riccati sweeps and the S2 projector, L and prox_h*),
  with the metric image of the residual and the SuperMann reductions when
  asked;
* ``metric_apply_fused`` applies the metric M in one launch of
  ``csrc/metric_apply.cu``, on the same two bodies (``metric_body``): the
  node body's metric pass, its lanes spread over blocks of four lanes that
  share a node tile (``metric_grid``), or the element body.

They take the JAX functions' arguments and return the same tuples, for the
JAX kernels' whole problem class (``supported``): costs and risk data uniform
or per node, a polyhedral dual cone, with or without two-sided polytope rows.
Both kernels are bound by memory: they read each lane's iterate and write
their outputs once (126 MB per plain sweep at the headline size, 38 us at
3.35 TB/s).

A sweep runs one of two bodies of ``csrc/cp_sweep.cu``, chosen here by the
problem's class (``sweep_body``) and passed to the kernel: the node body of
``csrc/step_body.cuh`` (a node per thread) when nx, nu and the polytope rows
of a node are at most 32 and its shared-memory plan fits (``node_plan``,
which mirrors the kernel's own), the element body of ``csrc/sweep_body.cuh``
otherwise.  The node body reads per-node cost matrices from node-minor
copies ([rows, cols, nodes]) that ``_consts`` makes once per problem.

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

# launches of each wrapper's kernel, and of csrc/cp_sweep.cu and
# csrc/metric_apply.cu by body
LAUNCHES = {"cp_sweep_fused": 0, "cp_sweep_metric_fused": 0,
            "candidate_sweep_fused": 0, "metric_apply_fused": 0,
            "cp_sweep_node_body": 0, "cp_sweep_element_body": 0,
            "metric_apply_node_body": 0, "metric_apply_element_body": 0}

MAX_STAGES = 24  # kMaxStages of csrc/sweep_common.cuh
MAX_KER = 32  # kMaxKer of csrc/sweep_body.cuh: ny + 2 d
MAX_DIM = 32  # kMaxDim of csrc/step_body.cuh: nx, nu, polytope rows
NODE, ELEMENT = "node", "element"
BODY_CODE = {ELEMENT: 0, NODE: 1}  # the body codes of the C entries
THREADS = 512  # kThreads of csrc/sweep_body.cuh
# csrc/step_body.cuh: values of one block reduction, dynamic shared memory
# per block, Riccati node groups at most
MAX_RED, SMEM_LIMIT, MAX_GROUPS = 9, 232448 - 4096, THREADS // 4
PRIMAL_BLOCKS = ("x", "u", "s", "tau", "y")
DUAL_ALL = DUAL_BLOCKS + ("pnl", "plf")
BLOCKS = PRIMAL_BLOCKS + DUAL_ALL  # the 19 blocks of csrc/sweep_common.cuh

_SIGNATURES = {
    "cp_sweep": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double,
                 ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_void_p],
    "metric_apply": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double,
                     ctypes.c_double, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p],
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


def _pad4(n: int) -> int:
    return (n + 3) // 4 * 4


def _cost_mats(meta: ProblemMeta, data: ProblemData) -> list:
    """The values of each staged region of step_body.cuh's
    ``plan_cost_mats``: sqrtQ, sqrtR, sqrtQN and their transposes where
    uniform (rows padded to 4 values), 0 where per node."""
    ldx, ldu = _pad4(meta.nx), _pad4(meta.nu)
    q, r, qn = (a.shape[0] == 1 for a in (data.sqrtQ, data.sqrtR,
                                           data.sqrtQN))
    return ([meta.nx * ldx] * 2 * q + [meta.nu * ldu] * 2 * r
            + [meta.nx * ldx] * 2 * qn)


def node_fits(meta: ProblemMeta) -> bool:
    """The node body holds a node's columns in registers: nx, nu and the
    polytope rows of a node are at most MAX_DIM."""
    return max(meta.nx, meta.nu, meta.nc_nl, meta.nc_lf) <= MAX_DIM


def metric_plan(meta: ProblemMeta, data: ProblemData, itemsize: int):
    """The shared memory of a node-body launch of csrc/metric_apply.cu for
    values of ``itemsize`` bytes, as step_body.cuh's ``metric_plan`` makes
    it: {bytes} per block, the uniform cost matrices and their transposes
    alone; None where the node body does not take the problem."""
    nbytes = sum(_pad4(n) for n in _cost_mats(meta, data)) * itemsize
    if not node_fits(meta) or nbytes > SMEM_LIMIT:
        return None
    return dict(bytes=nbytes)


def node_plan(meta: ProblemMeta, data: ProblemData, itemsize: int):
    """The node body's shared-memory plan for values of ``itemsize`` bytes,
    as csrc/step_body.cuh's ``node_fits`` and ``plan_smem`` make it:
    {bytes, costates_in_shared_memory, riccati_groups, costate_values} per
    block (costate_values per lane), or None where the node body does not
    take the problem.  Uniform matrices are staged, per-node ones are not;
    the costates stay in shared memory when they fit, with as many Riccati
    node groups as fit."""
    t = meta.tree
    nx, nu, d = meta.nx, meta.nu, t.d
    if not node_fits(meta):
        return None
    ldx, ldu = _pad4(nx), _pad4(nu)
    mker = meta.ny + 2 * d
    ker = data.ker_proj.shape[0] == 1
    staged = _cost_mats(meta, data) + [d * nu * ldx, d * nx * ldu,
                                       mker * _pad4(mker) * ker]
    o = sum(_pad4(n) for n in staged)
    backward = nu * ldu + d * nx * ldu + d * nx * ldx + nx * ldu
    forward = nu * ldx + d * nx * ldx
    o = _pad4(o + max(backward, forward))
    xch_node = 3 * ldu + d * ldx
    qsize = (t.n_leaf + t.stage_size(t.N - 2)) * ldx
    red = MAX_RED * THREADS
    for q_shared in (True, False):
        cmax = MAX_GROUPS
        while cmax >= (16 if q_shared else 1):
            work = qsize if q_shared and qsize > red else red
            total = o + cmax * xch_node + work
            if total * itemsize <= SMEM_LIMIT:
                return dict(bytes=total * itemsize,
                            costates_in_shared_memory=q_shared,
                            riccati_groups=cmax, costate_values=qsize)
            cmax //= 2
    return None


def sweep_body(meta: ProblemMeta, data: ProblemData, dtype) -> str:
    """The body of csrc/cp_sweep.cu that runs the problem, by its class:
    ``NODE`` where ``node_plan`` fits, ``ELEMENT`` otherwise.  Raises on a
    problem outside the sweep kernels' class."""
    if not supported(meta, data):
        raise ValueError("sweep kernels: unsupported problem class")
    itemsize = torch.finfo(dtype).bits // 8
    return ELEMENT if node_plan(meta, data, itemsize) is None else NODE


def metric_body(meta: ProblemMeta, data: ProblemData, dtype) -> str:
    """The body of csrc/metric_apply.cu that runs the problem, by the rule of
    ``sweep_body``: ``NODE`` where ``metric_plan`` fits, ``ELEMENT``
    otherwise.  Raises on a problem outside the kernels' class."""
    if not supported(meta, data):
        raise ValueError("metric kernel: unsupported problem class")
    itemsize = torch.finfo(dtype).bits // 8
    return ELEMENT if metric_plan(meta, data, itemsize) is None else NODE


NODE_TILE = 32  # kNodeTile of csrc/metric_apply.cu: a warp's nodes
METRIC_LANES = 4  # its kMetricLanes: lanes (warps) a block


def metric_grid(meta: ProblemMeta, B: int) -> dict:
    """The node body's launch of csrc/metric_apply.cu at B lanes: a grid of
    (node tiles, lane groups) blocks of METRIC_LANES warps, each warp one
    lane on the tile's NODE_TILE nodes (the last group's surplus warps
    idle)."""
    n = meta.tree.n
    return dict(tiles=-(-n // NODE_TILE), groups=-(-B // METRIC_LANES),
                lanes=METRIC_LANES, threads=32 * METRIC_LANES)


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
N_CONSTS = 21  # the constants before the node-minor copies


def node_minor(a):
    """The node-minor copy [rows, cols, nodes] of per-node matrices a
    [nodes, rows, cols]; None for a uniform a (one node)."""
    return None if a.shape[0] == 1 else a.permute(1, 2, 0).contiguous()


def _consts(data: ProblemData, meta: ProblemMeta) -> list:
    """The kernels' constants, contiguous, in csrc/sweep_body.cuh's
    make_consts order: sqrtQ, sqrtR, sqrtQN and b (whole, with their node
    dimension), the polytope rows Gx, Gu and GxN, ker_proj, the stage stacks
    of K, Rtinv, ABK and PB, B, the box bounds and the polytope bounds
    (None where the problem has no polytope), then the node-minor copies of
    sqrtQ, sqrtR and sqrtQN (None where uniform), made once per ``data``."""
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
    consts += [node_minor(a) for a in (data.sqrtQ, data.sqrtR, data.sqrtQN)]
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
    for unused ones) and the int array ``dims``; raise on a CUDA error (a
    request the kernel does not take is cudaErrorInvalidValue, 1)."""
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


def _scratch(body, meta, data, B, dtype, device) -> list:
    """The four scratch pointers of csrc/cp_sweep.cu for ``body``: the node
    body's dvec [B, n_nl, ldu] and, where they do not fit in shared memory,
    costates [B, qsize]; the element body's costates, w, dvec and inner."""
    t = meta.tree

    def empty(n):
        return torch.empty((B, n), dtype=dtype, device=device)

    if body == NODE:
        plan = node_plan(meta, data, torch.finfo(dtype).bits // 8)
        costates = (None if plan["costates_in_shared_memory"]
                    else empty(plan["costate_values"]))
        return [empty(t.n_nonleaf * _pad4(meta.nu)), costates, None, None]
    mmax = t.stage_size(t.N - 2)
    return [empty(n) for n in (meta.nx * t.n, meta.nu * mmax,
                               meta.nu * t.n_nonleaf, t.d * meta.nx * mmax)]


def _sweep(name, data, meta, z, v, gamma, sigma, x0, metric, direction=None):
    """Launch csrc/cp_sweep.cu on the body the problem's class takes;
    returns the output tensors (19 of zbar/vbar, then with ``metric`` 19 of
    M r and the [6, B] scalar rows)."""
    device, dtype, B, shapes, ins, consts = _inputs(name, data, meta, z, v)
    body = sweep_body(meta, data, dtype)
    _check(name, [x0], [(B, meta.nx)], device, dtype)
    dirs, tau = [None] * len(BLOCKS), None
    if direction is not None:
        dz, dv, tau = direction
        dirs = _blocks(dz, dv)
        _check(name, dirs, shapes, device, dtype)
        tau = torch.as_tensor(tau, dtype=dtype, device=device)
        tau = tau.expand(B).contiguous() if tau.ndim == 0 else tau
        _check(name, [tau], [(B,)], device, dtype)
    outs = _empty(shapes, dtype, device)
    mrs = _empty(shapes, dtype, device) if metric else [None] * len(BLOCKS)
    scal = torch.empty((6, B), dtype=dtype, device=device)
    scratch = _scratch(body, meta, data, B, dtype, device)
    ptr = [_ptr(a) for a in ins + dirs + outs + mrs + list(scal) + [x0, tau]
           + consts + scratch]
    _launch(name, "cp_sweep", dtype, device, ptr, _dims(data, meta, True),
            float(gamma), float(sigma), int(metric),
            int(direction is not None), BODY_CODE[body], B)
    LAUNCHES[f"cp_sweep_{body}_body"] += 1
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
    """M (z, v) in one launch on the body the problem's class takes; returns
    (Mz, Mv)."""
    name = "metric_apply_fused"
    if _on_cpu(z.s, v.sby):
        return metric_apply(data, meta, z, v, gamma, sigma)
    device, dtype, B, shapes, ins, consts = _inputs(name, data, meta, z, v)
    body = metric_body(meta, data, dtype)
    outs = _empty(shapes, dtype, device)
    ptr = [_ptr(a) for a in ins + outs + consts[:N_LMATS]
           + consts[N_CONSTS:]]
    _launch(name, "metric_apply", dtype, device, ptr,
            _dims(data, meta, False), float(gamma), float(sigma),
            BODY_CODE[body], B)
    LAUNCHES[f"metric_apply_{body}_body"] += 1
    return _pair(outs)
