#!/usr/bin/env python3
"""Times variants of two kernels of the PyTorch/CUDA port on one NVIDIA GPU,
each compiled from a copy of ``spock_tpu_torch/csrc`` with a few lines
changed, so that the choices the sources make can be checked against their
neighbours on one card in one call; with ``--parent DIR`` also the same two
kernels of another checkout (an earlier commit unpacked with ``git archive``),
timed in turns with the current ones.

    python3 kernel_variants.py [--parent build/parent]

- csrc/metric_apply.cu (kernel #5, node body): the rows a thread batches
  (``kMetricBatch``: 2, 4, 8); the blocks an SM that the launch bound asks
  for (``kMetricMinBlocks``: 2, 3, 4, 6, 8, which cap a thread at 255,
  168, 128, 80 and 64 registers), batch 8 also at 3; the lanes a block
  (``kMetricLanes``: 1, 2, 4, 8, 16, at the same 128-register cap); the
  per-node cost rows of a tile's own edges (sqrtQ, and sqrtQ with sqrtR)
  staged in shared memory by the block and read from there by its lanes,
  at 4 and 16 lanes a block, beside a copy that only drops the read-only
  loads (``__ldg``) that shared memory cannot take.
  Each on the headline (server_heat N=10 nx=nu=20 d=2, float32) at B = 128
  and at the Broyden Solver's B = 4, and on chip_smoke.py's ``_pncost``
  configuration at B = 128;
- csrc/prox_h_conj.cu (kernel #1): the 16-byte vectors an elementwise
  thread owns (``kUnroll``: 2, 4, 8), 256 threads a block, the SOC pass's
  column held in registers between the norm and the scaling (read once), and
  the SOC and elementwise passes alone and as two launches, at the headline,
  B = 128.

Each variant that writes every output is held against the plain PyTorch
version first.  Prints ptxas's registers and spill bytes of each variant's
float32 kernel and one JSON line of median CUDA-event milliseconds
(chip_smoke.py's ``time_ms``) with the card's name and power limit; the
copies are built under ``build/variants/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

HERE = Path(__file__).resolve().parent
CSRC = Path("spock_tpu_torch") / "csrc"
OUT = HERE / "build" / "variants"

BATCH = "constexpr int kMetricBatch = 4;"
LANES = "constexpr int kMetricLanes = 4;"
MIN_BLOCKS = "constexpr int kMetricMinBlocks = 4;"


def _batch(b):
    return ("metric_apply.cu", BATCH, f"constexpr int kMetricBatch = {b};")


def _min_blocks(n):
    return ("metric_apply.cu", MIN_BLOCKS,
            f"constexpr int kMetricMinBlocks = {n};")


def _lanes(n):
    """n lanes a block, its blocks an SM set so that the register cap stays
    at 128 a thread."""
    return [("metric_apply.cu", LANES, f"constexpr int kMetricLanes = {n};"),
            _min_blocks(16 // n)]

NO_LDG = ("step_body.cuh", "if (q < n) acc += __ldg(p + q * cs) * w[q];",
          "if (q < n) acc += p[q * cs] * w[q];")

# Staging of a tile's own per-node cost rows: the block copies sqrtQ (and,
# with STAGE_R, sqrtR) of the edges into its 32 nodes from the node-minor
# copies into shared memory [entry][node of the tile], after the uniform
# matrices, and metric_node's L rows of those matrices read them from there
# (its L' child rows stay in device memory).
STAGED = [
    NO_LDG,
    ("step_body.cuh", "// The residual of a metric pass that accumulates "
     "nothing", """#ifndef STAGE_R
#define STAGE_R 0
#endif
template <typename T>
__host__ __device__ inline bool stages(const SweepConsts<T>& k) {
  return k.nmQ != nullptr && (!STAGE_R || k.nmR != nullptr);
}

// The residual of a metric pass that accumulates nothing"""),
    ("step_body.cuh", "mat_rows(sm + s.Q, ldx, X.k.nmQ, nx, n_nr, j, false)",
     "mat_rows(sm + s.Q, ldx, stages(X.k) ? sm + s.bytes / int(sizeof(T)) "
     ": X.k.nmQ, nx, stages(X.k) ? 32 : n_nr, stages(X.k) ? "
     "int(threadIdx.x % 32) : j, false)"),
    ("step_body.cuh", "mat_rows(sm + s.R, ldu, X.k.nmR, nu, n_nr, j, false)",
     "mat_rows(sm + s.R, ldu, STAGE_R && stages(X.k) ? sm + s.bytes / "
     "int(sizeof(T)) + nx * nx * 32 : X.k.nmR, nu, STAGE_R && stages(X.k) ? "
     "32 : n_nr, STAGE_R && stages(X.k) ? int(threadIdx.x % 32) : j, "
     "false)"),
    ("metric_apply.cu", "template <typename T>\nstruct MetricNodeParams {",
     """template <typename T>
__host__ __device__ inline int staged_values(const SweepConsts<T>& k) {
  return stages(k) ? (k.g.nx * k.g.nx + (STAGE_R ? k.g.nu * k.g.nu : 0)) *
                         kNodeTile
                   : 0;
}

template <typename T>
__device__ void stage_tile_rows(const StepConsts<T>& X, T* st, int tile0) {
  const Geo& g = X.k.g;
  const int nq = g.nx * g.nx;
  const int n = staged_values(X.k);
  for (int e = threadIdx.x; e < n; e += kMetricThreads) {
    const int slot = e % kNodeTile, el = e / kNodeTile;
    const int j = tile0 + slot - 1;
    const T* src = el < nq ? X.k.nmQ + el * g.n_nr
                           : X.k.nmR + (el - nq) * g.n_nr;
    st[e] = j >= 0 && j < g.n_nr ? src[j] : T(0);
  }
}

template <typename T>
struct MetricNodeParams {"""),
    ("metric_apply.cu",
     "  stage_cost_mats(P.x, sm, threadIdx.x, kMetricThreads);",
     "  stage_cost_mats(P.x, sm, threadIdx.x, kMetricThreads);\n"
     "  stage_tile_rows(P.x, sm + P.x.s.bytes / int(sizeof(T)),\n"
     "                  blockIdx.x * kNodeTile);"),
    ("metric_apply.cu", "  P.B = B;\n",
     "  P.B = B;\n  const int sbytes =\n"
     "      P.x.s.bytes + staged_values(k) * static_cast<int>(sizeof(T));\n"),
    ("metric_apply.cu", "if (P.x.s.bytes > 48 * 1024)",
     "if (sbytes > 48 * 1024)"),
    ("metric_apply.cu", "        P.x.s.bytes);", "        sbytes);"),
    ("metric_apply.cu", "kMetricThreads, P.x.s.bytes, stream",
     "kMetricThreads, sbytes, stream"),
]

METRIC = {
    **{f"batch{b}": ([_batch(b)], ()) for b in (2, 4, 8)},
    **{f"min_blocks{n}": ([_min_blocks(n)], ()) for n in (2, 3, 6, 8)},
    "batch8_min_blocks3": ([_batch(8), _min_blocks(3)], ()),
    **{f"lanes{n}": (_lanes(n), ()) for n in (1, 2, 8, 16)},
    "no_ldg": ([NO_LDG], ()),
    "stage_q": (STAGED, ()),
    "stage_qr": (STAGED, ("-DSTAGE_R=1",)),
    "stage_q_lanes16": (STAGED + _lanes(16), ()),
    "stage_qr_lanes16": (STAGED + _lanes(16), ("-DSTAGE_R=1",)),
}

SOC_LOOPED = """  T acc = T(0);
  for (int r = 0; r < a; ++r) {"""
SOC_REGISTERS = """  constexpr int kRegRows = 32;
  if (a <= kRegRows && b <= kRegRows) {
    // every load of the column issued before its first use, then the norm
    // and the scaling from the registers: each value read once
    T va[kRegRows], vb[kRegRows];
#pragma unroll
    for (int r = 0; r < kRegRows; ++r) {
      if (r < a) va[r] = pa[r * ld] * inv;
    }
#pragma unroll
    for (int r = 0; r < kRegRows; ++r) {
      if (r < b) vb[r] = pb[r * ld] * inv;
    }
    T acc = we * we;
#pragma unroll
    for (int r = 0; r < kRegRows; ++r) {
      if (r < a) acc += va[r] * va[r];
      if (r < b) acc += vb[r] * vb[r];
    }
    T t_out, xs;
    soc_pieces(wt, acc, t_out, xs);
    *ot = sigma * (wt - t_out);
#pragma unroll
    for (int r = 0; r < kRegRows; ++r) {
      if (r < a) qa[r * ld] = sigma * (va[r] - xs * va[r]);
      if (r < b) qb[r * ld] = sigma * (vb[r] - xs * vb[r]);
    }
    *oe = sigma * (we - xs * we);
    return;
  }
""" + SOC_LOOPED
SOC_ONLY = ("prox_h_conj.cu",
            "const int64_t nblk = (P.elen[k] + kBlockValues - 1) / "
            "kBlockValues;", "const int64_t nblk = 0;")
ELEM_ONLY = ("prox_h_conj.cu",
             "const int64_t soc_blocks = (P.soc + kThreads - 1) / kThreads;",
             "const int64_t soc_blocks = 0;")
PROX = {
    "unroll2": ([("prox_h_conj.cu", "constexpr int kUnroll = 4;",
                  "constexpr int kUnroll = 2;")], ()),
    "unroll4": ([], ()),
    "unroll8": ([("prox_h_conj.cu", "constexpr int kUnroll = 4;",
                  "constexpr int kUnroll = 8;")], ()),
    "threads256": ([("prox_h_conj.cu", "constexpr int kThreads = 128;",
                     "constexpr int kThreads = 256;")], ()),
    "soc_registers": ([("prox_h_conj.cu", SOC_LOOPED, SOC_REGISTERS)], ()),
    "soc_pass_alone": ([SOC_ONLY], ()),
    "elementwise_pass_alone": ([ELEM_ONLY], ()),
}


def build_all(variants, parent=None):
    """Compile each variant (``{name: (source, replacements, flags)}``: a
    copy of ``csrc`` with each (file, old, new) replaced once) and, with
    ``parent``, that checkout's two sources as ``parent/<source>``, all at
    once; returns ({name: CDLL}, {name: ptxas summary})."""
    from spock_tpu_torch.ops import _build

    jobs = {}
    for name, (src, edits, flags) in variants.items():
        d = OUT / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(HERE / CSRC, d)
        for fname, old, new in edits:
            text = (d / fname).read_text()
            cs.check(old in text, f"{name}: {old!r} not in {fname}")
            (d / fname).write_text(text.replace(old, new, 1))
        jobs[name] = (d / src, flags)
    if parent:
        d = OUT / "parent"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(Path(parent) / CSRC, d)
        for src in ("metric_apply", "prox_h_conj"):
            jobs[f"parent/{src}"] = (d / f"{src}.cu", ())
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-shared", "-o",
         str(OUT / f"{name.replace('/', '_')}.so"), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (path, flags) in jobs.items()}
    libs, ptxas = {}, {}
    for name, p in procs.items():
        log = p.communicate()[0]
        cs.check(p.returncode == 0, f"{name}: nvcc failed\n{log}")
        libs[name] = ctypes.CDLL(str(OUT / f"{name.replace('/', '_')}.so"))
        ptxas[name] = {e: info for e, info in cs.ptxas_summary(log).items()
                       if ("metric_node_kernelIf" in e
                           or "prox_h_conj_kernelIf" in e
                           or "metric_apply_kernelIf" in e)}
    return libs, ptxas


def metric_call(lib, data, meta, z, v, g, parent=False):
    """M (z, v) by a variant's node body (or the parent's kernel), through
    its C entry."""
    from spock_tpu_torch.ops import sweep_kernels as sk

    fn = lib.metric_apply_f32
    fn.argtypes = (sk._SIGNATURES["metric_apply"][:4]
                   + [ctypes.c_int] * (1 if parent else 2)
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    B = z.s.shape[0]
    outs = sk._empty(sk.pair_shapes(meta, B), torch.float32, z.s.device)
    consts = sk._consts(data, meta)
    ptr = [sk._ptr(a) for a in sk._blocks(z, v) + outs
           + consts[:sk.N_LMATS] + ([] if parent else consts[sk.N_CONSTS:])]
    ptrs = (ctypes.c_void_p * len(ptr))(*ptr)
    dims = sk._dims(data, meta, False)
    head = (ctypes.addressof(ptrs), ctypes.addressof(dims), float(g),
            float(g))
    rc = sk._call(fn, head + ((B,) if parent else (sk.BODY_CODE[sk.NODE], B)),
                  z.s.device)
    cs.check(rc == 0, f"metric variant: CUDA error {rc}")
    return sk._pair(outs)


def prox_call(libs, data, meta, v, sigma, outs=None):
    """prox_h* by a variant (one library, or several launched in order into
    the same outputs), through its C entry."""
    from spock_tpu_torch.ops import cuda_kernels
    from spock_tpu_torch.zv import DUAL_BLOCKS, Dual

    blocks = [getattr(v, k) for k in DUAL_BLOCKS]
    outs = outs or [torch.empty_like(a) for a in blocks]
    ptrs = [(ctypes.c_void_p * len(a))(*[x.data_ptr() for x in a])
            for a in (blocks, outs, [data.x_min, data.x_max, data.u_min,
                                     data.u_max])]
    segs = cuda_kernels.cone_segments(meta.dual_cone)
    triples = (ctypes.c_int * max(1, 3 * len(segs)))(
        *[x for kind, lo, hi in segs
          for x in (cuda_kernels.KIND[kind], lo, hi)])
    t = meta.tree
    for lib in libs if isinstance(libs, (list, tuple)) else [libs]:
        fn = lib.prox_h_conj_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_double, ctypes.c_double] + [
            ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        rc = fn(*map(ctypes.addressof, ptrs), ctypes.addressof(triples),
                len(segs), float(sigma), 1.0 / float(sigma), v.sby.shape[0],
                meta.nx, meta.nu, meta.ny, t.n_nonleaf, t.n_leaf,
                torch.cuda.current_stream().cuda_stream)
        cs.check(rc == 0, f"prox variant: CUDA error {rc}")
    return Dual(**dict(zip(DUAL_BLOCKS, outs)))


def in_turns(kernel, parent):
    """Device ms of the current kernel and the parent's on the same inputs,
    timed parent, current, current, parent."""
    p1, k1, k2, p2 = (cs.time_ms(f) for f in (parent, kernel, kernel,
                                              parent))
    return dict(kernel_ms=[k1, k2], parent_ms=[p1, p2])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another checkout whose two kernels "
                    "are timed in turns with the current ones")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_variants: no CUDA device; nothing was run")
    from spock_tpu_torch import build
    from spock_tpu_torch.models import server_heat
    from spock_tpu_torch.ops import _build, cuda_kernels, linop, prox
    from spock_tpu_torch.ops import sweep_kernels as sk
    from spock_tpu_torch.problem import step_size
    from spock_tpu_torch.zv import Dual

    _build.start(["metric_apply", "prox_h_conj"])
    variants = {**{k: ("metric_apply.cu", *e) for k, e in METRIC.items()},
                **{k: ("prox_h_conj.cu", *e) for k, e in PROX.items()}}
    libs, ptxas = build_all(variants, args.parent)
    card = cs.card_line()
    for name, entries in ptxas.items():
        for entry, info in entries.items():
            print(f"[ptxas] {name}: {entry}: {info.get('registers')} "
                  f"registers, {info['spill_stores']} B spill stores, "
                  f"{info['spill_loads']} B spill loads", flush=True)
    spec = server_heat.make_spec(N=cs.N, nx=cs.NX, d=cs.D)
    data, meta = build(spec, dtype=torch.float32)
    pdata, pmeta = build(cs.wide_specs(spec)[1], dtype=torch.float32)
    out = dict(card=card, ptxas=ptxas, metric={}, prox={}, parent={})
    for label, (d_, m_), batch in (("headline", (data, meta), cs.B),
                                   ("headline", (data, meta), 4),
                                   (cs.PNCOST, (pdata, pmeta), cs.B)):
        key = f"{label} B={batch}"
        rng = np.random.default_rng(1)
        z, v = sk.new_pair(m_, batch, lambda s: torch.tensor(
            rng.standard_normal(s), dtype=torch.float32, device="cuda"))
        g = step_size(d_)
        ref = linop.metric_apply(d_, m_, z, v, g, g)
        ms = out["metric"][key] = {}
        for name in METRIC:
            cs.hold(f"{name} {key}", metric_call(libs[name], d_, m_, z, v,
                                                 g), ref)
            ms[name] = cs.time_ms(
                lambda: metric_call(libs[name], d_, m_, z, v, g))
        print(f"[variants] metric_apply {key} ms: " + ", ".join(
            f"{k} {t:.4f}" for k, t in ms.items()) + f" [{card}]",
            flush=True)
        if args.parent:
            lib = libs["parent/metric_apply"]
            cs.hold(f"parent {key}", metric_call(lib, d_, m_, z, v, g, True),
                    ref)
            out["parent"][f"metric_apply {key}"] = t = in_turns(
                lambda: sk.metric_apply_fused(d_, m_, z, v, g, g),
                lambda: metric_call(lib, d_, m_, z, v, g, True))
            print(f"[parent] metric_apply {key}: {t} [{card}]", flush=True)
    rng = np.random.default_rng(0)
    v = Dual(**{k: torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                                device="cuda")
                for k, s in cuda_kernels.block_shapes(meta, cs.B).items()})
    sigma = step_size(data)
    ref = prox.prox_h_conj(data, meta, v, sigma)
    split = [libs["soc_pass_alone"], libs["elementwise_pass_alone"]]
    runs = {**{k: libs[k] for k in PROX}, "passes_as_two_launches": split}
    for name, lib in runs.items():
        if not name.endswith("alone"):  # alone: half the outputs unwritten
            cs.hold(name, prox_call(lib, data, meta, v, sigma), ref)
        out["prox"][name] = cs.time_ms(
            lambda: prox_call(lib, data, meta, v, sigma))
    print("[variants] prox_h_conj headline B=128 ms: " + ", ".join(
        f"{k} {t:.4f}" for k, t in out["prox"].items()) + f" [{card}]",
        flush=True)
    if args.parent:
        lib = libs["parent/prox_h_conj"]
        cs.hold("parent prox_h_conj", prox_call(lib, data, meta, v, sigma),
                ref)
        out["parent"]["prox_h_conj headline B=128"] = t = in_turns(
            lambda: cuda_kernels.prox_h_conj_fused(data, meta, v, sigma),
            lambda: prox_call(lib, data, meta, v, sigma))
        print(f"[parent] prox_h_conj headline B=128: {t} [{card}]",
              flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
