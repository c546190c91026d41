"""The prox_h* CUDA kernel of the port, its wrapper and launch count.

``prox_h_conj_fused`` is the prox_h* phase of a CP sweep on the composed path
(``fused_sweep=False``, or a problem the sweep kernels of
:mod:`spock_tpu_torch.ops.sweep_kernels` do not cover); its kernel is
``csrc/prox_h_conj.cu`` and it replaces the Pallas TPU kernel
``spock_tpu/ops/pallas_kernels.py::prox_h_conj_fused``.  The kernel is bound
by memory: it reads and writes the nv values of the dual iterate once per
lane (90 MB per launch at the headline size, about 27 us at 3.35 TB/s).  It
runs two passes, the second-order cones a column per thread and the blocks
that need no column as a flat elementwise stream; one launch runs both.

The wrapper takes the plain version (:func:`spock_tpu_torch.ops.prox.
prox_h_conj`) only for tensors that lie on the CPU.  For CUDA tensors it
launches the kernel or raises; nothing falls back.  ``LAUNCHES`` counts the
kernel launches, so that a run can show that its main path went through the
kernel.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..problem import ProblemData, ProblemMeta
from ..zv import DUAL_BLOCKS, Dual
from . import _build
from .prox import prox_h_conj

LAUNCHES = 0
# every wrapper adds to its launch counts under this lock: a run may launch
# from several host threads (chip_smoke.py's config 3 rows)
COUNT_LOCK = threading.Lock()

# kind codes of the dual-cone row segments (same as csrc/prox_h_conj.cu and
# csrc/cp_sweep.cu)
KIND = {"zero": 0, "nonneg": 1, "nonpos": 2, "reals": 3}
MAX_SEGMENTS = 8

_bound = set()


def cone_segments(dual_spec):
    """Static (kind, start, end) row segments of a polyhedral product cone."""
    segs = []
    off = 0
    for kind, dim in dual_spec:
        segs.append((kind, off, off + dim))
        off += dim
    return tuple(segs)


def supported(meta: ProblemMeta) -> bool:
    """The kernel covers polyhedral dual cones without polytope rows."""
    if meta.nc_nl or meta.nc_lf:
        return False
    return (all(k in KIND for k, _ in meta.dual_cone)
            and len(meta.dual_cone) <= MAX_SEGMENTS)


def _fn(dtype: torch.dtype):
    lib = _build.library("prox_h_conj")
    name = {torch.float32: "prox_h_conj_f32",
            torch.float64: "prox_h_conj_f64"}[dtype]
    fn = getattr(lib, name)
    if name not in _bound:
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _bound.add(name)
    return fn


def block_shapes(meta: ProblemMeta, B: int) -> dict:
    """The [B, ...] shape of each of the 12 dual blocks the kernel takes."""
    t = meta.tree
    nx, nu, ny = meta.nx, meta.nu, meta.ny
    n_nl, n_nr, n_lf = t.n_nonleaf, t.n - 1, t.n_leaf
    return dict(
        y=(B, ny, n_nl), sby=(B, n_nl), qx=(B, nx, n_nr), ru=(B, nu, n_nr),
        t5=(B, n_nr), t6=(B, n_nr), cx=(B, nx, n_nl), cu=(B, nu, n_nl),
        qNx=(B, nx, n_lf), s12=(B, n_lf), s13=(B, n_lf), cxN=(B, nx, n_lf),
    )


def prox_h_conj_fused(data: ProblemData, meta: ProblemMeta, v: Dual,
                      sigma) -> Dual:
    """prox_{sigma h*}(v) for a batch of lanes (every block [B, ...])."""
    blocks = [getattr(v, name) for name in DUAL_BLOCKS]
    bounds = [data.x_min, data.x_max, data.u_min, data.u_max]
    if all(a.device.type == "cpu" for a in blocks):
        return prox_h_conj(data, meta, v, sigma)

    if not supported(meta) or v.pnl is not None or v.plf is not None:
        raise ValueError("prox_h_conj kernel: unsupported problem class")
    device = v.sby.device
    dtype = v.sby.dtype
    if device.type != "cuda":
        raise ValueError(f"prox_h_conj kernel: tensors on {device}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"prox_h_conj kernel: dtype {dtype} not supported")
    B = v.sby.shape[0]
    if B < 1:
        raise ValueError(f"prox_h_conj kernel: batch {B} out of range")
    shapes = block_shapes(meta, B)
    for name, a in zip(DUAL_BLOCKS, blocks):
        if a.device != device or a.dtype != dtype:
            raise ValueError(f"prox_h_conj kernel: {name} is {a.dtype} on "
                             f"{a.device}, expected {dtype} on {device}")
        if tuple(a.shape) != shapes[name]:
            raise ValueError(f"prox_h_conj kernel: {name} has shape "
                             f"{tuple(a.shape)}, expected {shapes[name]}")
        if not a.is_contiguous():
            raise ValueError(f"prox_h_conj kernel: {name} is not contiguous")
    for a, k in zip(bounds, (meta.nx, meta.nx, meta.nu, meta.nu)):
        if (a.device != device or a.dtype != dtype or tuple(a.shape) != (k,)
                or not a.is_contiguous()):
            raise ValueError("prox_h_conj kernel: box bounds do not match "
                             "the iterate")

    fn = _fn(dtype)
    outs = [torch.empty_like(a) for a in blocks]
    in_ptrs = (ctypes.c_void_p * 12)(*[a.data_ptr() for a in blocks])
    out_ptrs = (ctypes.c_void_p * 12)(*[a.data_ptr() for a in outs])
    bound_ptrs = (ctypes.c_void_p * 4)(*[a.data_ptr() for a in bounds])
    segs = cone_segments(meta.dual_cone)
    triples = (ctypes.c_int * max(1, 3 * len(segs)))(
        *[x for kind, lo, hi in segs for x in (KIND[kind], lo, hi)])
    sigma = float(sigma)
    t = meta.tree
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(
            ctypes.addressof(in_ptrs), ctypes.addressof(out_ptrs),
            ctypes.addressof(bound_ptrs), ctypes.addressof(triples),
            len(segs), sigma, 1.0 / sigma, B, meta.nx, meta.nu, meta.ny,
            t.n_nonleaf, t.n_leaf, stream,
        )
    if rc != 0:
        raise RuntimeError(f"prox_h_conj kernel launch failed: CUDA error {rc}")
    _count()
    return Dual(**dict(zip(DUAL_BLOCKS, outs)))


def _count() -> None:
    global LAUNCHES
    with COUNT_LOCK:
        LAUNCHES += 1
