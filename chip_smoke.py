#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``spock_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. environment: the card's name and power limit (nvidia-smi), the torch and
   CUDA versions, and the TF32 switches, which must be off;
2. build: every kernel under ``spock_tpu_torch/csrc`` (prox_h_conj,
   cp_sweep, metric_apply, sp_step) with nvcc for sm_90a, one nvcc per
   source: the first three together, then sp_step (minutes of ptxas) in a
   thread while phase 3 and the ``_pncost`` farm of 7d run, waited for
   just before the step kernels' first use;
3. each kernel against its plain PyTorch version at the shapes of the main
   path (B = 128 lanes of server_heat N=10 nx=nu=20 d=2, float32), and both
   timed with CUDA events: prox_h_conj, cp_sweep_fused,
   cp_sweep_metric_fused, candidate_sweep_fused and metric_apply_fused on
   random inputs; after 4a, the step kernels of csrc/sp_step.cu (the
   function of both TPU step kernels) on a real carry, one fused iteration
   into a solve from the main path's final state, held in float64 and
   timed in float32: sp_step_fused at tau = 1 with the carry's cache
   flags, and sp_step_retrial (a backtracking retrial on the zbar and d
   the tau = 1 launch kept) on the lanes that launch leaves looping, on
   the first of them alone and on all B lanes; the ptxas report and the shared-memory plan of the step
   kernels are printed after the build;
4. the paths, each driven with every kernel launch count set to 0 just
   before it and read just after:
   a. the main path, ``mpc.simulate_async`` on the fused step: the
      warm-started async MPC farm of B = 128 server_heat chains at tol 1e-3
      (a cold phase of 2 steps, then a warm phase of 24 steps chained from
      its state), where every SuperMann iteration is one sp_step_fused
      launch plus one sp_step_retrial launch per backtracking retrial, over
      the lanes still looping (their mean number is reported);
   b. the same farm on the fused sweep (``fused_step=False``), where every
      CP sweep is one launch of a sweep kernel;
   c. the same farm on the composed path (``fused_sweep=False``), whose
      prox_h* phase is the prox_h_conj kernel;
   d. ``Solver(algorithm="cp")``, one cp_sweep_fused launch per iteration,
      and e. ``Solver`` with Broyden directions, one metric_apply_fused
      launch per iteration, both warm-started from 4 lanes of the main
      path's farm at its final states;
5. the solution: the float32 root controls of a cold 1-step farm on the
   main path from the warm phase's states against the port's own float64
   solve on the CPU (composed iteration, tol 1e-5) for 2 lanes, and the
   controls of 4d and 4e at the same states against the same solve;
6. where the time goes: ``torch.profiler`` over 10 warm farm iterations of
   the main path (device time per iteration, kernels per iteration, the
   step kernel's share, the top kernels);
7. the wider problem class, in two configurations built here from the
   headline spec with ``dataclasses.replace``: ``server_heat_poly_navar``
   (per-node AV@R and two-sided polytope rows) and
   ``server_heat_poly_navar_pncost`` (the same with per-node costs):
   a. kernels #2-#5 against their plain versions on ``_pncost`` (all three
      widenings at once), random float32 inputs at B lanes, timed;
   b. the ``_navar`` farm on the fused step, as 4a (the step kernels
      alone);
   c. the step kernels on a real ``_navar`` carry, as in phase 3;
   d. the ``_pncost`` farm, on the sweep kernels #3 and #4 (the step
      kernel's class has uniform costs), and a CP and a Broyden ``Solver``
      warm-started from it (#2, #5);
   e. the solutions: the root controls of both farms and of the two solves
      against the port's float64 CPU solves, the root polytope rows, and
      that the polytope binds (the float64 objective with it exceeds the one
      without it).

The float64 CPU solves of phases 5 and 7e run in REF_WORKERS worker
processes, each started as soon as its farm has given the check states, so
they overlap the card's phases; the farms of 7d and 7b therefore run first,
right after phase 3, the ``_pncost`` farm ahead, since its solve (1022
per-node matrices) is the longest and takes REF_THREADS_PNCOST threads.  The
workers are stopped when the script ends, whatever happens.

The last lines are the card, one JSON object with a row per kernel, and the
result line ``{"ok": true, "device": {...}}``.  Numbers also go to
``build/chip_smoke.json``.  The script imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import functools
import json
import math
import multiprocessing
import os
import subprocess
import sys
import time
import types

import numpy as np
import torch

# headline configuration of the main path
N, NX, D = 10, 20, 2
B = 128
TOL = 1e-3
# 2 cold steps, then 24 warm steps chained from them: the warm phase ends
# near the farm's steady state, where the solution check of phase 5 is made
COLD_STEPS, WARM_STEPS = 2, 24
COLD_CAP, WARM_CAP = 1500, 1500  # farm-iteration caps: a stuck lane fails fast
PROFILE_ITERS = 10
CHECK_LANES = 2
SOLVE_LANES = 4  # lanes of the CP and Broyden solves (Broyden: 29.6 MB each)
CP_CAP, BROYDEN_CAP = 5000, 1000
CONTROLS_TOL = 1e-4  # BASELINE.json: f32 root controls vs a float64 solve
# the warm-started Solver runs stop at tol 1e-3 on their residual, measured
# from a small first residual: their controls lie within a few tol of the
# exact solution, and 10 tol marks a wrong answer
SOLVE_CONTROLS_TOL = 10 * TOL
KERNEL_RTOL = 1e-5  # max|kernel - plain| <= 1e-5 (1 + scale) per output
# the step kernel in float64 against its plain version: every output within
# 1e-9 (1 + scale); in float32 its K1/K2 decisions are compared instead
STEP_RTOL64 = 1e-9
# except the Anderson weights (output slots 10-12): near convergence the
# regularised 3x3 Gram's condition number reaches ~1e10, so float64 sums in
# another order move the weights by up to ~1e-6 of their size; their effect
# on the step is held at STEP_RTOL64 through z_new, w and the other outputs
STEP_WEIGHTS_RTOL64 = 1e-5
# fused iterations from the main path's final state before the step is
# held: its warm solves mostly converge in 1-2 iterations, so after one most
# lanes are still active, as on the farm right after a refill
STEP_ITERS = 1
TIMING_REPS = 50
SPIN_CYCLES = 20_000_000  # ~10 ms at the H100's clocks: longer than any enqueue
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
SWEEP_KERNELS = {  # wrapper -> (source, the TPU kernel it replaces)
    "cp_sweep_fused": ("spock_tpu_torch/csrc/cp_sweep.cu",
                       "spock_tpu/ops/pallas_sweep.py:1302::cp_sweep_fused"),
    "cp_sweep_metric_fused": (
        "spock_tpu_torch/csrc/cp_sweep.cu",
        "spock_tpu/ops/pallas_sweep.py:1320::cp_sweep_metric_fused"),
    "candidate_sweep_fused": (
        "spock_tpu_torch/csrc/cp_sweep.cu",
        "spock_tpu/ops/pallas_sweep.py:1345::candidate_sweep_fused"),
    "metric_apply_fused": (
        "spock_tpu_torch/csrc/metric_apply.cu",
        "spock_tpu/ops/pallas_sweep.py:1174::metric_apply_fused"),
}
STEP_SOURCE = "spock_tpu_torch/csrc/sp_step.cu"
OC_G0, OC_G2 = 10, 12  # the Anderson weights' output slots (spstep.OC_*)
STEP_ROWS = {  # row -> the TPU kernel whose function it holds
    "sp_step_fused": "spock_tpu/ops/pallas_spstep.py:1340::sp_step_fused",
    "sp_step_fused_tau1":
        "spock_tpu/ops/pallas_spstep_lt.py:1093::sp_step_fused",
}
# the wider class: per-node AV@R (seed 5), the polytope rows
#   non-leaf  lo <= [1'/nx ; e0 - e1] x + [0.5 1'/nx ; 0.5 e0] u <= hi
#   leaf      loN <= 1'/nx x <= hiN
# (every non-leaf row holds u, so the root stays feasible whatever the plant
# does), and per-node costs by the spd() recipe (seed 31).  The closed loop
# regulates the plants toward the origin, where a band symmetric about 0
# never binds: loN = 0.005 keeps the mean leaf temperature just above it,
# which doubles the objective at the check states and keeps the f32 farm's
# controls within CONTROLS_TOL (a band further from 0 moves them further)
POLY_LO, POLY_HI = (-0.2, -0.4), (0.2, 0.4)
POLY_LO_N, POLY_HI_N = (0.005,), (0.15,)
NAVAR, PNCOST = "poly_navar", "poly_navar_pncost"
ROOT_ROWS_TOL = 1e-3  # the f32 farm's root polytope rows, as tol
BIND_MARGIN = 1e-4  # objective with the polytope - without, at a check state
# the float64 CPU reference solves run in worker processes beside the card's
# phases: per-node AV@R slows their convergence (thousands of iterations).
# Each takes one thread but the _pncost solve, whose per-node matrix products
# are large enough to gain from more (of the host's 8 cores)
REF_WORKERS, REF_CAP = 4, 10_000
REF_THREADS_PNCOST = 4


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, reps=TIMING_REPS, warmup=5, spin=SPIN_CYCLES):
    """Median device milliseconds of ``fn()`` over ``reps`` CUDA-event timed
    calls.  A spin kernel queued ahead of each start event keeps the card
    busy while the host enqueues ``fn``, so the host's launch cost stays out
    of the reading."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def ptxas_summary(log):
    """Registers, spill bytes (the entry's and those of the functions it
    calls, summed) and static shared memory of each kernel entry in an
    ``nvcc -Xptxas -v`` log: {entry: dict}."""
    import re

    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            out[entry] = dict(spill_stores=0, spill_loads=0)
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[entry]["spill_stores"] += int(m.group(1))
            out[entry]["spill_loads"] += int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[entry]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[entry]["static_smem"] = int(sm.group(1)) if sm else 0
    return out


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate and
    the operations over the float32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def nbytes_of(tensors):
    return sum(a.numel() * a.element_size() for a in tensors
               if a is not None)


def abs_err(got, ref) -> float:
    """max|got - ref|, where equal values (infinities too) differ by 0."""
    return float(torch.where(got == ref, 0.0, (got - ref).abs()).max())


def hold(name, got, ref, scales=None, rtol=KERNEL_RTOL):
    """max|kernel - plain| over the output leaves; each must lie within
    rtol (1 + scale), scale = max|plain| unless given."""
    from spock_tpu_torch.zv import leaves

    got, ref = leaves(got), leaves(ref)
    check(len(got) == len(ref), f"{name}: {len(got)} outputs, plain {len(ref)}")
    max_err = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        # an infinite output (the step's r_safe of a lane that never took
        # K1) must equal the plain version's
        check(bool((torch.isfinite(g) | (g == r)).all()),
              f"{name}: output {i} not finite")
        err = abs_err(g, r)
        finite = r[torch.isfinite(r)]
        scale = (scales or {}).get(
            i, float(finite.abs().max()) if finite.numel() else 0.0)
        check(err <= rtol * (1.0 + scale),
              f"{name} kernel disagrees on output {i}: {err} > "
              f"{rtol} * (1 + {scale})")
        max_err = max(max_err, err)
    return max_err


def wide_specs(spec):
    """The ``_navar`` and ``_pncost`` specs from the headline spec."""
    import dataclasses

    from spock_tpu_torch import problem, risks

    t, nx = spec.tree, NX
    rng = np.random.default_rng(5)
    ps = rng.dirichlet(np.ones(D), t.n_nonleaf)
    alphas = rng.uniform(0.7, 0.99, t.n_nonleaf)
    mean = np.ones((1, nx)) / nx
    e0, e1 = np.eye(nx)[:1], np.eye(nx)[1:2]
    poly = problem.Polytope(
        Gx=np.concatenate([mean, e0 - e1]), Gu=np.concatenate([0.5 * mean,
                                                             0.5 * e0]),
        lo=np.array(POLY_LO), hi=np.array(POLY_HI), GxN=mean,
        loN=np.array(POLY_LO_N), hiN=np.array(POLY_HI_N))
    navar = dataclasses.replace(
        spec, risk=risks.avar_nonuniform(ps, alphas), polytope=poly)
    rng = np.random.default_rng(31)

    def spd(n_nodes, base):
        out = base * rng.uniform(0.5, 2.0, (n_nodes, 1, 1)) * np.eye(nx)
        out = out + rng.uniform(-0.02, 0.02, (n_nodes, nx, nx))
        return 0.5 * (out + out.transpose(0, 2, 1)) + 0.1 * np.eye(nx)

    pncost = dataclasses.replace(navar, cost=problem.Cost(
        Q=spd(t.n - 1, 0.1), R=spd(t.n - 1, 1.0), QN=spd(t.n_leaf, 0.1)))
    return navar, pncost


def kernel_row(name, source, replaces, max_err, kernel_ms, plain_ms,
               nbytes, ops, card):
    """One row of the ``kernels`` line; its launches are filled in from the
    path that runs it."""
    bound_ms, bound_by = bound(nbytes, ops)
    print(f"[kernel] {name} B={B} max_abs_err={max_err:.3e} kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} "
          f"ms ({nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP) [{card}]",
          flush=True)
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=None, max_abs_err=max_err, ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def prox_kernel_check(data, meta, card):
    """Phase 3: prox_h_conj kernel against its plain version at B lanes."""
    from spock_tpu_torch.ops import cuda_kernels, prox
    from spock_tpu_torch.problem import step_size
    from spock_tpu_torch.zv import Dual, leaves

    rng = np.random.default_rng(0)
    v = Dual(**{k: torch.tensor(rng.standard_normal(s), dtype=data.dtype,
                                device=data.device)
                for k, s in cuda_kernels.block_shapes(meta, B).items()})
    sigma = step_size(data)

    def kernel():
        return cuda_kernels.prox_h_conj_fused(data, meta, v, sigma)

    def plain():
        return prox.prox_h_conj(data, meta, v, sigma)

    got = kernel()
    torch.cuda.synchronize()
    max_err = hold("prox_h_conj", got, plain())
    n_vals = sum(a.numel() for a in leaves(v))
    nbytes = nbytes_of(leaves(v) + leaves(got) + [
        data.x_min, data.x_max, data.u_min, data.u_max])
    ops = 6 * n_vals  # scale, shift, square/compare, subtract, scale back
    return kernel_row("prox_h_conj", "spock_tpu_torch/csrc/prox_h_conj.cu",
                      "spock_tpu/ops/pallas_kernels.py:175::prox_h_conj_fused",
                      max_err, time_ms(kernel), time_ms(plain), nbytes, ops,
                      card)


def sweep_ops(meta, metric, direction, sweep=True):
    """Floating-point operations per lane of a sweep kernel (a multiply-add
    counts 2): the matrix blocks of L and L', the Riccati sweeps, the S2
    projector, and ~10 elementwise operations per value of the pair."""
    t = meta.tree
    nx, nu, ny, d = meta.nx, meta.nu, meta.ny, t.d
    n_nl, n_nr, n_lf = t.n_nonleaf, t.n - 1, t.n_leaf
    pair = meta.nz + meta.nv
    l_ops = 2 * (n_nl * ny + n_nr * (nx * nx + nu * nu) + n_lf * nx * nx
                 + n_nl * meta.nc_nl * (nx + nu) + n_lf * meta.nc_lf * nx)
    ops = 2 * l_ops + 2 * pair  # one L and one L' application: M
    if sweep:
        mker = ny + 2 * d
        ops += 2 * n_nl * (2 * d * nx * nu + nu * nu + d * nx * nx + nu * nx)
        ops += 2 * n_nl * (nu * nx + d * nx * nx + d * nx * nu)
        ops += 2 * n_nl * mker * mker + 10 * pair
        ops += (2 * l_ops + 4 * pair) * (int(metric) + int(direction))
    return ops


def row_name(name, tag):
    return name if tag is None else f"{name}[{tag}]"


def sweep_kernel_checks(data, meta, card, tag=None):
    """Phase 3 (7a with ``tag``): the four whole-sweep kernels against their
    plain versions; the rows are named ``name[tag]``."""
    from spock_tpu_torch.algorithms import common
    from spock_tpu_torch.ops import linop, sweep_kernels
    from spock_tpu_torch.problem import step_size
    from spock_tpu_torch.zv import leaves, sub, tmap

    rng = np.random.default_rng(1)

    def pair():
        return sweep_kernels.new_pair(meta, B, lambda s: torch.tensor(
            rng.standard_normal(s), dtype=data.dtype, device=data.device))

    (z, v), (dz, dv) = pair(), pair()
    x0 = torch.tensor(rng.uniform(-0.6, 0.6, (B, meta.nx)), dtype=data.dtype,
                      device=data.device)
    tau = torch.tensor(rng.random(B), dtype=data.dtype, device=data.device)
    g = s = step_size(data)
    w = tmap(lambda a, b: a + tau.reshape((B,) + (1,) * (a.ndim - 1)) * b,
             (z, v), (dz, dv))
    calls = {
        "cp_sweep_fused": (
            lambda: sweep_kernels.cp_sweep_fused(data, meta, z, v, g, s, x0),
            lambda: common.cp_sweep_ref(data, meta, z, v, g, s, x0),
            [z, v, x0]),
        "cp_sweep_metric_fused": (
            lambda: sweep_kernels.cp_sweep_metric_fused(data, meta, z, v, g,
                                                        s, x0),
            lambda: common.cp_sweep_metric_ref(data, meta, z, v, g, s, x0),
            [z, v, x0]),
        "candidate_sweep_fused": (
            lambda: sweep_kernels.candidate_sweep_fused(data, meta, z, v, dz,
                                                        dv, tau, g, s, x0),
            lambda: common.candidate_sweep_ref(data, meta, z, v, dz, dv, tau,
                                               g, s, x0),
            [z, v, dz, dv, tau, x0]),
        "metric_apply_fused": (
            lambda: sweep_kernels.metric_apply_fused(data, meta, z, v, g, s),
            lambda: linop.metric_apply(data, meta, z, v, g, s),
            [z, v]),
    }
    consts = sweep_kernels._consts(data, meta)
    rows = []
    for name, (kernel, plain, inputs) in calls.items():
        got = kernel()
        torch.cuda.synchronize()
        ref = plain()
        scales = {}
        if name in ("cp_sweep_metric_fused", "candidate_sweep_fused"):
            # the dot products: their rounding scales with sum |a_i b_i|;
            # they follow the two pairs (z-bar, v-bar) and M r
            dot = 2 * len(leaves(ref[:2]))
            base = (z, v) if name == "cp_sweep_metric_fused" else w
            r = sub(base, (ref[0], ref[1]))
            scales[dot] = float(sum(
                (a.abs() * b.abs()).flatten(1).sum(1)
                for a, b in zip(leaves(r), leaves(ref[2:4]))).max())
            if name == "candidate_sweep_fused":
                md = linop.metric_apply(data, meta, dz, dv, g, s)
                scales[dot + 3] = float(sum(
                    (a.abs() * b.abs()).flatten(1).sum(1)
                    for a, b in zip(leaves(r), leaves(md))).max())
        max_err = hold(row_name(name, tag), got, ref, scales)
        used = (consts[:sweep_kernels.N_LMATS] if name == "metric_apply_fused"
                else consts)
        nbytes = nbytes_of(leaves(tuple(inputs)) + leaves(got) + used)
        ops = B * sweep_ops(meta, name != "cp_sweep_fused",
                            name == "candidate_sweep_fused",
                            sweep=name != "metric_apply_fused")
        source, replaces = SWEEP_KERNELS[name]
        rows.append(kernel_row(row_name(name, tag), source, replaces,
                               max_err, time_ms(kernel), time_ms(plain),
                               nbytes, ops, card))
    return rows


def step_carry(data, meta, res2, opts):
    """The fused-step carry STEP_ITERS iterations into a solve from the
    farm's final state (its plant states, warm z and v): a real carry, with
    lanes of every kind (cached or not, done or not)."""
    from spock_tpu_torch.algorithms import supermann as sp

    c = sp.sp_init_fused(meta, res2.xs, res2.z, res2.v, opts)
    bodies = [sp.sp_body_fused(data, meta, TOL, opts, phase=ph)
              for ph in range(3)]
    for k in range(STEP_ITERS):
        c = bodies[k % 3](c)
    return c


def step_bytes_ops(meta, args, out, consts):
    """Bytes the tau = 1 step's function must move (each input read once,
    each of its six output pairs and its scalars written once; a lane reads
    the cache pair only when its cache flag is set; what the kernel keeps
    for the retrials is not counted) and its floating-point operations (the
    fresh sweep only for lanes without a cache, the candidate sweep, and ~40
    operations per value of the pair for the residual, the Gram sums, the
    direction and the commit)."""
    from spock_tpu_torch.ops import spstep
    from spock_tpu_torch.zv import leaves

    scal = args[10]
    cached = float((scal[:, spstep.SC_CACHE] > 0).double().mean())
    pair_bytes = nbytes_of(leaves(args[:2]))
    nbytes = (nbytes_of(leaves(args)) - (1.0 - cached) * pair_bytes
              + nbytes_of(leaves(out[:7])) + nbytes_of(consts))
    per_lane = ((1.0 - cached) * sweep_ops(meta, True, False)
                + sweep_ops(meta, True, True) + 40 * (meta.nz + meta.nv))
    return nbytes, B * per_lane


def retrial_bytes_ops(meta, k, pair_bytes, consts):
    """Bytes and operations of a retrial of k lanes: z, d and zbar read and
    z_new and s written at those lanes (the pair of one lane is
    pair_bytes / B), the constants once; the candidate sweep and ~20
    operations per value for the commit."""
    nbytes = 5 * k * pair_bytes / B + nbytes_of(consts)
    return nbytes, k * (sweep_ops(meta, True, True)
                        + 20 * (meta.nz + meta.nv))


def hold_step(name, got, ref, lanes=None):
    """A step's six pairs (or the retrial's z_new and s) and its output
    slots 0-12 in float64 against the plain version's, with identical K1 /
    K2 / loop decisions; ``lanes`` picks the rows of the pairs to compare.
    Returns the largest error and the errors by slot."""
    from spock_tpu_torch.zv import tmap

    gs, rs = got[-1], ref[-1]
    check(bool((gs[:, :3] == rs[:, :3]).all()),
          f"{name}: float64 K1/K2 decisions differ from the plain version")
    pick = (lambda a: a) if lanes is None else (lambda a: a[lanes])
    max_err = hold(name, tmap(pick, got[:-1]), tmap(pick, ref[:-1]),
                   rtol=STEP_RTOL64)
    slot_err = []
    for j in range(OC_G2 + 1):
        rtol = STEP_WEIGHTS_RTOL64 if j >= OC_G0 else STEP_RTOL64
        slot_err.append(hold(f"{name} output slot {j}", gs[:, j], rs[:, j],
                             rtol=rtol))
    return max(max_err, *slot_err), slot_err


def step_kernel_checks(data, meta, spec, res2, card, opts, tag=None,
                       mean_lanes=None):
    """Phase 3, step rows, on a real carry at B lanes:
    - the tau = 1 launch with the carry's cache flags (the function of the
      lane-tiled TPU kernel, #7) against sp_step_ref;
    - a retrial (#6) of the lanes that launch leaves looping, at tau = beta
      on the zbar and d it kept, against sp_retrial_ref, and in float64 also
      against sp_step_ref with no cache at tau = beta on those lanes (from a
      tau = 1 launch with no cache, so that its zbar is the fresh sweep);
    - the retrial of the first of those lanes alone, and of all B lanes.
    Each is held in float64 and timed in float32, where the K1/K2 decisions
    of kernel and plain version are compared lane by lane.  Also times the
    tau = 1 launch with every lane cached and with none.  ``mean_lanes``:
    the farm's mean looping lanes per retrial, taken when the carry leaves
    no lane looping.  Rows and messages are named ``name[tag]``."""
    from spock_tpu_torch import build
    from spock_tpu_torch.algorithms import supermann as sp
    from spock_tpu_torch.ops import spstep, sweep_kernels
    from spock_tpu_torch.problem import step_size
    from spock_tpu_torch.zv import leaves, tmap

    c = step_carry(data, meta, res2, opts)
    phase = c.it % 3
    act = ~c.done
    ones = torch.ones_like(c.r_safe)
    no_cache = torch.zeros_like(c.cache_valid)
    knobs = dict(c1=opts.c1, sigma_k2=opts.sigma_k2, lam=opts.lam,
                 lam_sp=opts.lam_sp)
    g = step_size(data)
    data64, meta64 = build(spec, dtype=torch.float64)
    g64 = step_size(data64)
    consts = sweep_kernels._consts(data, meta)
    rows, extra = [], {}

    def inputs(cache, tau, dtype=torch.float32):
        args = sp.step_inputs(c, opts, phase, act, cache, c.r_safe, tau)
        return args if dtype == torch.float32 else tmap(
            lambda a: a.double(), args)

    def f32_agreement(label, got, ref, lanes_=None):
        """Decisions of kernel and plain lane by lane; values on the lanes
        that agree (the Anderson weights apart: float32 sums in another
        order move ill-conditioned weights far)."""
        agree = (got[-1][:, :3] == ref[-1][:, :3]).all(dim=1)
        sel = agree if lanes_ is None else lanes_[agree]
        err32 = max(abs_err(a[sel], b[sel])
                    for a, b in zip(leaves(got[:-1]), leaves(ref[:-1])))
        err32 = max(err32, abs_err(got[-1][agree, :10], ref[-1][agree, :10]))
        err32_w = abs_err(got[-1][agree, 10:13], ref[-1][agree, 10:13])
        check(not math.isnan(err32), f"{label}: float32 outputs disagree")
        return dict(f32_decisions_agree=int(agree.sum()),
                    lanes=int(agree.numel()),
                    f32_max_abs_err_agreeing=err32,
                    f32_weights_max_abs_err_agreeing=err32_w,
                    plain_k1_k2_loop=ref[-1][:, :3].sum(0).tolist())

    def report(label, max_err, slot_err, e32, what):
        print(f"[step] {label}: float64 max_abs_err {max_err:.3e} (limit "
              f"{STEP_RTOL64} (1 + scale), Anderson weights "
              f"{STEP_WEIGHTS_RTOL64}); by output slot "
              f"{', '.join(f'{e:.1e}' for e in slot_err)}; float32 "
              f"decisions agree on {e32['f32_decisions_agree']}/"
              f"{e32['lanes']} lanes (plain K1/K2/loop "
              f"{e32['plain_k1_k2_loop']}), max_abs_err on them "
              f"{e32['f32_max_abs_err_agreeing']:.3e} (Anderson weights "
              f"{e32['f32_weights_max_abs_err_agreeing']:.3e}); {what} "
              f"[{card}]", flush=True)

    # ---- tau = 1 with the carry's cache flags (#7) ----
    name = row_name("sp_step_fused_tau1", tag)
    args64 = inputs(c.cache_valid, ones, torch.float64)
    got64 = spstep.sp_step_fused(data64, meta64, *args64, g64, g64, **knobs)
    torch.cuda.synchronize()
    ref64 = spstep.sp_step_ref(data64, meta64, *args64, g64, g64, **knobs)
    max_err, slot_err = hold_step(name, got64[:7], ref64[:7])
    args = inputs(c.cache_valid, ones)

    def tau1(args=args):
        return spstep.sp_step_fused(data, meta, *args, g, g, **knobs)

    got = tau1()
    ref = spstep.sp_step_ref(data, meta, *args, g, g, **knobs)
    torch.cuda.synchronize()
    e32 = f32_agreement(name, got[:7], ref[:7])
    cached = int((c.cache_valid & act).sum())
    extra[name] = dict(f64_slot_max_abs_err=slot_err, **e32,
                       cached_lanes=int(c.cache_valid.sum()),
                       active_lanes=int(act.sum()))
    report(name, max_err, slot_err, e32,
           f"{int(c.cache_valid.sum())} cached ({cached} of them active), "
           f"{int(act.sum())} active lanes")
    nbytes, ops = step_bytes_ops(meta, args, got, consts)
    rows.append(kernel_row(name, STEP_SOURCE, STEP_ROWS["sp_step_fused_tau1"],
                           max_err, time_ms(tau1),
                           time_ms(lambda: spstep.sp_step_ref(
                               data, meta, *args, g, g, **knobs),
                               spin=4 * SPIN_CYCLES), nbytes, ops, card))

    # ---- the retrial (#6): the lanes the carry loops on, then all ----
    looping = torch.nonzero(got64[6][:, spstep.OC_LOOP] > 0.5).flatten()
    if looping.numel() == 0:
        k = max(1, round(mean_lanes or 1))
        looping = torch.nonzero(act).flatten()[:k]
        print(f"[step] the carry leaves no lane looping: the retrial row "
              f"takes the first {looping.numel()} active lanes", flush=True)
    tau_bt = torch.full_like(c.r_safe, opts.beta)
    scal_bt = inputs(c.cache_valid, tau_bt)[-1]
    scal_bt64 = scal_bt.double()
    # against sp_step_ref with no cache at tau = beta, on a keep with no
    # cache: the retrial's function
    nc64 = inputs(no_cache, ones, torch.float64)
    keep_nc = spstep.sp_step_fused(data64, meta64, *nc64, g64, g64, **knobs)
    ref_bt = spstep.sp_step_ref(
        data64, meta64, *inputs(no_cache, tau_bt, torch.float64), g64, g64,
        **knobs)
    sc_nc = spstep.sp_step_retrial(
        data64, meta64, *nc64[:2], keep_nc[7], nc64[9], scal_bt64, looping,
        keep_nc[0], keep_nc[3], g64, g64, **knobs)
    torch.cuda.synchronize()
    fn_err, _ = hold_step(
        row_name("sp_step_retrial vs sp_step_ref", tag),
        (keep_nc[0], keep_nc[3], sc_nc),
        (ref_bt[0], ref_bt[3], ref_bt[6][looping]), lanes=looping)
    for label, lanes in (("sp_step_retrial", looping),
                         ("sp_step_retrial_one", looping[:1]),
                         ("sp_step_retrial_all", torch.arange(
                             B, device=looping.device))):
        name = row_name(label, tag)
        # float64: kernel and plain version on the same kept zbar and d
        zk, sk = tmap(torch.clone, got64[0]), tmap(torch.clone, got64[3])
        zr, sr = tmap(torch.clone, got64[0]), tmap(torch.clone, got64[3])
        out64 = spstep.sp_step_retrial(data64, meta64, *args64[:2], got64[7],
                                       args64[9], scal_bt64, lanes, zk, sk,
                                       g64, g64, **knobs)
        torch.cuda.synchronize()
        outr = spstep.sp_retrial_ref(data64, meta64, *args64[:2], got64[7],
                                     args64[9], scal_bt64, lanes, zr, sr,
                                     g64, g64, **knobs)
        max_err, slot_err = hold_step(name, (zk, sk, out64), (zr, sr, outr))
        # float32, on the float32 launch's keep
        zk, sk = tmap(torch.clone, got[0]), tmap(torch.clone, got[3])
        zr, sr = tmap(torch.clone, got[0]), tmap(torch.clone, got[3])
        out32 = spstep.sp_step_retrial(data, meta, *args[:2], got[7],
                                       args[9], scal_bt, lanes, zk, sk, g, g,
                                       **knobs)
        outr32 = spstep.sp_retrial_ref(data, meta, *args[:2], got[7],
                                       args[9], scal_bt, lanes, zr, sr, g, g,
                                       **knobs)
        torch.cuda.synchronize()
        e32 = f32_agreement(name, (zk, sk, out32), (zr, sr, outr32), lanes)
        extra[name] = dict(f64_slot_max_abs_err=slot_err, **e32,
                           retrial_lanes=int(lanes.numel()),
                           f64_max_abs_err_vs_sp_step_ref=fn_err)
        report(name, max_err, slot_err, e32,
               f"{lanes.numel()} lanes at tau = {opts.beta}; against "
               f"sp_step_ref with no cache on the looping lanes "
               f"{fn_err:.3e}")
        zt, st = tmap(torch.clone, got[0]), tmap(torch.clone, got[3])

        def kernel(lanes=lanes, zt=zt, st=st):
            return spstep.sp_step_retrial(data, meta, *args[:2], got[7],
                                          args[9], scal_bt, lanes, zt, st, g,
                                          g, **knobs)

        def plain(lanes=lanes, zt=zt, st=st):
            return spstep.sp_retrial_ref(data, meta, *args[:2], got[7],
                                         args[9], scal_bt, lanes, zt, st, g,
                                         g, **knobs)

        nbytes, ops = retrial_bytes_ops(meta, int(lanes.numel()),
                                        nbytes_of(leaves(args[:2])), consts)
        rows.append(kernel_row(name, STEP_SOURCE, STEP_ROWS["sp_step_fused"],
                               max_err, time_ms(kernel),
                               time_ms(plain, spin=4 * SPIN_CYCLES), nbytes,
                               ops, card))

    # the per-lane fresh-sweep skip: the launch at tau = 1 with every lane
    # cached and with none
    skip = {}
    for label, flag in (("all_cached", True), ("none_cached", False)):
        a = inputs(torch.full_like(c.cache_valid, flag), ones)
        skip[label] = time_ms(
            lambda a=a: spstep.sp_step_fused(data, meta, *a, g, g, **knobs))
    skip["carry_flags"] = rows[0]["ms"]
    extra["cache_skip_ms"] = skip
    print(f"[step] {row_name('tau = 1', tag)} launch: "
          f"{skip['carry_flags']:.4f} ms with the "
          f"carry's cache flags, {skip['all_cached']:.4f} ms with every lane "
          f"cached, {skip['none_cached']:.4f} ms with none [{card}]",
          flush=True)
    return rows, extra


def launch_counts():
    from spock_tpu_torch.ops import cuda_kernels, spstep, sweep_kernels

    return dict(sweep_kernels.LAUNCHES, **spstep.LAUNCHES,
                prox_h_conj=cuda_kernels.LAUNCHES)


def reset_counts():
    from spock_tpu_torch.ops import cuda_kernels, spstep, sweep_kernels

    cuda_kernels.LAUNCHES = 0
    spstep.RETRIAL_LANES = 0
    for counts in (sweep_kernels.LAUNCHES, spstep.LAUNCHES):
        for k in counts:
            counts[k] = 0


def check_step_farm(counts, farm_iters, label):
    """A farm on the fused step: one sp_step_fused launch per farm iteration
    and retrial launches, no other kernel.  Returns the retrial launches per
    farm iteration."""
    check(counts["sp_step_fused"] == farm_iters,
          f"{label}: sp_step_fused launched {counts['sp_step_fused']} times "
          f"in {farm_iters} farm iterations")
    others = {k: c for k, c in counts.items()
              if k not in ("sp_step_fused", "sp_step_retrial")}
    check(not any(others.values()),
          f"the {label} farm launched other kernels: {others}")
    return counts["sp_step_retrial"] / farm_iters


def step_launches(rows, counts):
    """The launches of the step rows on their farm: the tau = 1 row's, then
    the retrial kernel's for the retrial rows."""
    rows[0]["launches"] = counts["sp_step_fused"]
    for row in rows[1:]:
        row["launches"] = counts["sp_step_retrial"]


def farm(data, meta, x0, ws, card, device, label, warm_steps, **path):
    """Phase 4a-4c: cold then warm async farm on the path given by the
    ``fused_sweep``/``fused_step`` switches in ``path``, with the launch
    counts set to 0 just before and read just after.  Returns both results,
    the numbers of the run and its farm iterations."""
    from spock_tpu_torch import mpc
    from spock_tpu_torch.ops import spstep

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    res1 = mpc.simulate_async(data, meta, x0, ws, TOL, n_steps=COLD_STEPS,
                              max_total_iters=COLD_CAP, device=device, **path)
    sync()
    cold_s = time.perf_counter() - t0
    check(bool((res1.steps_done == COLD_STEPS).all()),
          f"{label} cold phase incomplete after {res1.total_iterations} farm "
          f"iterations: steps_done={res1.steps_done.tolist()}")
    t0 = time.perf_counter()
    res2 = mpc.simulate_async(data, meta, res1.xs, ws, TOL, n_steps=warm_steps,
                              max_total_iters=WARM_CAP, z0=res1.z, v0=res1.v,
                              device=device, **path)
    sync()
    warm_s = time.perf_counter() - t0
    counts = launch_counts()
    retrial_lanes = spstep.RETRIAL_LANES
    check(bool((res2.steps_done == warm_steps).all()),
          f"{label} warm phase incomplete after {res2.total_iterations} farm "
          f"iterations: steps_done={res2.steps_done.tolist()}")
    iters = res2.iters_per_step[:warm_steps].double().cpu().numpy()
    farm_iters = res1.total_iterations + res2.total_iterations
    nums = dict(
        warm_steps=warm_steps,
        cold_farm_iterations=res1.total_iterations,
        cold_wall_s=cold_s,
        warm_farm_iterations=res2.total_iterations,
        warm_wall_s=warm_s,
        warm_solves=int(res2.steps_done.sum()),
        solves_per_s=int(res2.steps_done.sum()) / warm_s,
        mean_iters_per_solve=float(iters.mean()),
        p99_iters=float(np.percentile(iters, 99)),
        ms_per_farm_iteration=1e3 * warm_s / res2.total_iterations,
        launches=counts,
        launches_per_farm_iteration={k: c / farm_iters
                                     for k, c in counts.items()},
        mean_lanes_per_retrial=(retrial_lanes / counts["sp_step_retrial"]
                                if counts["sp_step_retrial"] else 0.0),
    )
    print(f"[{label} farm] cold {COLD_STEPS} steps: "
          f"{res1.total_iterations} farm iterations in {cold_s:.2f} s; warm "
          f"{warm_steps} steps: {res2.total_iterations} farm iterations in "
          f"{warm_s:.2f} s -> {nums['solves_per_s']:.2f} solves/s, mean "
          f"{nums['mean_iters_per_solve']:.2f} / p99 {nums['p99_iters']:.1f} "
          f"iterations per solve, {nums['ms_per_farm_iteration']:.2f} ms per "
          f"farm iteration [{card}]", flush=True)
    per = ", ".join(f"{k} {c} ({c / farm_iters:.2f}/iter)"
                    for k, c in counts.items() if c)
    print(f"[{label} farm] launches over {farm_iters} farm iterations: {per}"
          + (f"; {nums['mean_lanes_per_retrial']:.2f} looping lanes per "
             "retrial launch" if counts["sp_step_retrial"] else ""),
          flush=True)
    return res1, res2, nums, farm_iters


def reference_solve(spec, xs, threads):
    """The port's float64 CPU solve (plain versions, composed iteration, tol
    1e-5) from the states xs [lanes, nx] (numpy), run in a worker process on
    ``threads`` threads: (root controls, objectives, seconds, iterations,
    converged)."""
    from spock_tpu_torch import build
    from spock_tpu_torch.solver import Solver

    torch.set_num_threads(threads)
    t0 = time.perf_counter()
    data64, meta64 = build(spec, dtype=torch.float64, device="cpu")
    ref = Solver(data64, meta64, algorithm="spock", max_iter=REF_CAP,
                 device="cpu", fused_step=False).solve(torch.tensor(xs),
                                                       tol=1e-5)
    return (ref.z.u[:, :, 0].numpy(), ref.z.s[:, 0].numpy(),
            time.perf_counter() - t0, ref.iterations.tolist(),
            bool(ref.converged.all()))


def submit_reference(pool, spec, xs, threads=1):
    """Start :func:`reference_solve` from the first CHECK_LANES states."""
    return pool.apply_async(reference_solve, (
        spec, xs[:CHECK_LANES].double().cpu().numpy(), threads))


def reference(job, label):
    """The result of a submitted reference solve, which must converge."""
    u, obj, seconds, iters, ok = job.get()
    check(ok, f"{label}: float64 CPU reference did not converge in {REF_CAP} "
          f"iterations: {iters}")
    return u, obj, seconds, iters


def solution_check(data, meta, spec, xs, ws, card, device, ref, tag=None,
                   ref_free=None):
    """Phase 5 (7e with ``tag``): f32 root controls of a cold 1-step farm on
    the configuration's default path against the port's float64 CPU solve
    ``ref`` (submitted from the same states).  With a polytope, also the
    root rows of the f32 controls, and with ``ref_free`` (the solve without
    the polytope) whether the polytope binds: the float64 objective with it
    exceeds the one without it by BIND_MARGIN at one of the check states.
    Returns the numbers and the reference controls."""
    from spock_tpu_torch import mpc

    label = row_name("solution", tag)
    res = mpc.simulate_async(data, meta, xs, ws, TOL, n_steps=1,
                             max_total_iters=COLD_CAP, device=device)
    check(bool((res.steps_done == 1).all()), f"{label}: cold 1-step farm "
          "incomplete")
    u_f32 = res.us[0, :CHECK_LANES].double().cpu().numpy()
    u_ref, obj, ref_s, ref_iters = reference(ref, label)
    err = float(np.abs(u_f32 - u_ref).max())
    print(f"[{label}] controls_max_err={err:.3e} over {CHECK_LANES} lanes "
          f"(f32 card farm vs f64 CPU solve: {ref_iters} iterations in "
          f"{ref_s:.1f} s, limit {CONTROLS_TOL}) [{card}]", flush=True)
    out = dict(controls_max_err=err, reference_s=ref_s,
               reference_iterations=ref_iters)
    poly = spec.polytope
    if poly is not None:
        x = xs[:CHECK_LANES].double().cpu().numpy()
        rows = x @ poly.Gx.T + u_f32 @ poly.Gu.T
        viol = float(np.maximum(np.maximum(rows - poly.hi, poly.lo - rows),
                                0.0).max())
        out.update(root_rows=rows.tolist(), root_rows_violation=viol)
        print(f"[{label}] root polytope rows {np.round(rows, 5).tolist()} "
              f"(bounds {poly.lo.tolist()} .. {poly.hi.tolist()}), "
              f"violation {viol:.3e} (limit {ROOT_ROWS_TOL}) [{card}]",
              flush=True)
    bind = ref_free is not None
    if bind:
        _, obj_free, free_s, _ = reference(ref_free, label)
        gap = (obj - obj_free).tolist()
        out.update(objective=obj.tolist(),
                   objective_without_polytope=obj_free.tolist(),
                   polytope_gap=gap)
        print(f"[{label}] f64 objective {obj.tolist()} with the polytope, "
              f"{obj_free.tolist()} without (solve {free_s:.1f} s): gap "
              f"{gap} (binds if > {BIND_MARGIN}) [{card}]", flush=True)
    check(err <= CONTROLS_TOL, f"{label}: controls_max_err {err} > "
          f"{CONTROLS_TOL}")
    if poly is not None:
        check(out["root_rows_violation"] <= ROOT_ROWS_TOL,
              f"{label}: root polytope rows violated by "
              f"{out['root_rows_violation']}")
    if bind:
        check(max(out["polytope_gap"]) > BIND_MARGIN,
              f"{label}: the polytope does not bind at the check states: "
              f"gap {out['polytope_gap']}")
    return out, u_ref


def solver_run(data, meta, res2, card, label, kernel, **solver_kw):
    """Phase 4d/4e: a Solver run warm-started from SOLVE_LANES lanes of the
    farm's final state, at the farm's final plant states, with the launch
    counts set to 0 just before and read just after.  Returns its numbers
    and the root controls of its first CHECK_LANES lanes."""
    from spock_tpu_torch.solver import Solver
    from spock_tpu_torch.zv import tmap

    def lanes(a):
        return a[:SOLVE_LANES].contiguous()

    solver = Solver(data, meta, **solver_kw)
    reset_counts()
    t0 = time.perf_counter()
    res = solver.solve(lanes(res2.xs), z0=tmap(lanes, res2.z),
                       v0=tmap(lanes, res2.v), tol=TOL)
    if data.device.type == "cuda":
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = launch_counts()
    iters = res.iterations.cpu().numpy()
    check(bool(res.converged.all()), f"{label} solve did not converge: "
          f"iterations {iters.tolist()}")
    u = res.z.u[:CHECK_LANES, :, 0].double().cpu().numpy()
    check(bool(np.isfinite(u).all()), f"{label} controls not finite")
    print(f"[{label}] {SOLVE_LANES} lanes warm: iterations {iters.tolist()} "
          f"in {wall_s:.2f} s; {kernel} launches {counts[kernel]} [{card}]",
          flush=True)
    check(counts[kernel] >= int(iters.max()),
          f"{label}: {kernel} launched {counts[kernel]} times in "
          f"{int(iters.max())} iterations")
    return dict(iterations=iters.tolist(), wall_s=wall_s, launches=counts), u


def solver_controls(runs, u_ref, card):
    """The root controls of warm-started Solver runs against the float64
    solve's, within SOLVE_CONTROLS_TOL."""
    for label, u, nums_ in runs:
        nums_["controls_err"] = float(np.abs(u - u_ref).max())
        print(f"[solution] {label}: controls {nums_['controls_err']:.3e} "
              f"from the f64 solve (limit {SOLVE_CONTROLS_TOL}) [{card}]",
              flush=True)
        check(nums_["controls_err"] <= SOLVE_CONTROLS_TOL,
              f"{label}: controls {nums_['controls_err']} from the f64 solve")


def wide_farms(spec, x0, ws, card, device, opts, pool, built):
    """The farm of 7d and phase 7b: the ``_pncost`` farm on the sweep
    kernels and the ``_navar`` farm on the fused step, each followed by the
    submission of its float64 reference solves; ``built()`` waits for the
    step kernels' build in between.  Returns their state."""
    import dataclasses

    from spock_tpu_torch import build
    from spock_tpu_torch.algorithms import supermann as sp
    from spock_tpu_torch.ops import spstep, sweep_kernels

    w = types.SimpleNamespace()
    w.spec_n, w.spec_p = wide_specs(spec)
    w.data_n, w.meta_n = build(w.spec_n, dtype=torch.float32)
    w.data_p, w.meta_p = build(w.spec_p, dtype=torch.float32)
    check(sp.use_fused_step(w.data_n, w.meta_n, opts),
          f"{NAVAR}: the fused step does not take the configuration")
    check(sweep_kernels.supported(w.meta_p, w.data_p)
          and not spstep.supported(w.meta_p, w.data_p),
          f"{PNCOST}: outside the sweep kernels' class, or inside the step "
          "kernel's")

    # 7d. the _pncost farm on the sweep kernels #3 and #4
    _, w.res2_p, w.pnums, p_iters = farm(
        w.data_p, w.meta_p, x0, ws, card, device, f"{PNCOST} fused-sweep",
        WARM_STEPS)
    pcounts = w.pnums["launches"]
    check(pcounts["cp_sweep_metric_fused"] >= 1
          and pcounts["candidate_sweep_fused"] >= p_iters,
          f"{PNCOST}: the farm's sweep launches {pcounts} in {p_iters} farm "
          "iterations")
    check(pcounts["sp_step_fused"] == 0 and pcounts["sp_step_retrial"] == 0
          and pcounts["prox_h_conj"] == 0,
          f"{PNCOST}: the farm launched the step or prox kernel")
    w.ref_p = submit_reference(pool, w.spec_p, w.res2_p.xs,
                               threads=REF_THREADS_PNCOST)
    built()

    # 7b. the _navar farm on the fused step: sp_step_fused alone
    _, w.res2_n, w.nnums, w.n_iters = farm(
        w.data_n, w.meta_n, x0, ws, card, device, f"{NAVAR} fused-step",
        WARM_STEPS)
    check_step_farm(w.nnums["launches"], w.n_iters, NAVAR)
    w.ref_n = submit_reference(pool, w.spec_n, w.res2_n.xs)
    w.ref_free = submit_reference(
        pool, dataclasses.replace(w.spec_n, polytope=None), w.res2_n.xs)
    return w


def wide_checks(w, ws, card, device, opts):
    """Phases 7a, 7c, the Solvers of 7d and 7e on the state of
    :func:`wide_farms`.  Returns the numbers, with the kernel rows (their
    launches from the path that ran them) under "rows"."""
    from spock_tpu_torch import SuperMannOpts

    # 7a. kernels #2-#5 on all three widenings at once
    prow = {r["name"]: r for r in sweep_kernel_checks(
        w.data_p, w.meta_p, card, tag=PNCOST)}
    for name in ("cp_sweep_metric_fused", "candidate_sweep_fused"):
        prow[row_name(name, PNCOST)]["launches"] = w.pnums["launches"][name]

    # 7c. the step kernel on a real _navar carry
    nrows, nextra = step_kernel_checks(
        w.data_n, w.meta_n, w.spec_n, w.res2_n, card, opts, tag=NAVAR,
        mean_lanes=w.nnums["mean_lanes_per_retrial"])
    step_launches(nrows, w.nnums["launches"])

    # 7d. the Solvers warm-started from the _pncost farm: #2 and #5
    cp, u_cp = solver_run(w.data_p, w.meta_p, w.res2_p, card,
                          f"cp solve [{PNCOST}]", "cp_sweep_fused",
                          algorithm="cp", max_iter=CP_CAP)
    prow[row_name("cp_sweep_fused", PNCOST)]["launches"] = (
        cp["launches"]["cp_sweep_fused"])
    broyden, u_broyden = solver_run(
        w.data_p, w.meta_p, w.res2_p, card, f"broyden solve [{PNCOST}]",
        "metric_apply_fused", max_iter=BROYDEN_CAP,
        supermann=SuperMannOpts(direction="broyden"))
    prow[row_name("metric_apply_fused", PNCOST)]["launches"] = (
        broyden["launches"]["metric_apply_fused"])

    # 7e. the solutions
    nsol, _ = solution_check(w.data_n, w.meta_n, w.spec_n, w.res2_n.xs, ws,
                             card, device, w.ref_n, tag=NAVAR,
                             ref_free=w.ref_free)
    psol, u_ref = solution_check(w.data_p, w.meta_p, w.spec_p, w.res2_p.xs,
                                 ws, card, device, w.ref_p, tag=PNCOST)
    solver_controls(((f"cp solve [{PNCOST}]", u_cp, cp),
                     (f"broyden solve [{PNCOST}]", u_broyden, broyden)),
                    u_ref, card)
    print(f"[paths] ms per farm iteration: {NAVAR} fused step "
          f"{w.nnums['ms_per_farm_iteration']:.2f}, {PNCOST} fused sweep "
          f"{w.pnums['ms_per_farm_iteration']:.2f}; solves/s "
          f"{w.nnums['solves_per_s']:.2f}, {w.pnums['solves_per_s']:.2f} "
          f"[{card}]", flush=True)
    return dict(rows=list(prow.values()) + nrows, navar_farm=w.nnums,
                navar_step=nextra, navar_solution=nsol, pncost_farm=w.pnums,
                pncost_solution=psol, pncost_cp_solve=cp,
                pncost_broyden_solve=broyden)


def profile_farm(data, meta, res2, ws, card, wall_ms_per_iter):
    """Phase 6: device time and kernel mix of PROFILE_ITERS warm farm
    iterations on the main path (a measurement: a profiler that sees no
    device time reports "not measured")."""
    from torch.profiler import ProfilerActivity, profile

    from spock_tpu_torch import mpc

    def run():
        return mpc.simulate_async(
            data, meta, res2.xs, ws, TOL, n_steps=ws.shape[0],
            max_total_iters=PROFILE_ITERS, z0=res2.z, v0=res2.v)

    run()  # same path once more, outside the profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = run()
        torch.cuda.synchronize()
    iters = res.total_iterations
    kernels = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            kernels.append((us, e.count, e.key))
    kernels.sort(reverse=True)
    device_ms = sum(k[0] for k in kernels) / 1e3 / iters
    launches = sum(k[1] for k in kernels) / iters
    if device_ms <= 0:
        print(f"[profile] device time not measured [{card}]", flush=True)
        return None
    top = [dict(name=k[2][:80], ms_per_iter=k[0] / 1e3 / iters,
                calls_per_iter=k[1] / iters) for k in kernels[:8]]
    step = [k for k in kernels
            if "sp_step_kernel" in k[2] or "sp_retrial_kernel" in k[2]]
    step_ms = sum(k[0] for k in step) / 1e3 / iters
    step_calls = sum(k[1] for k in step) / iters
    out = dict(device_ms_per_iter=device_ms,
               device_kernels_per_iter=launches,
               wall_ms_per_iter_unprofiled=wall_ms_per_iter,
               device_busy_share=device_ms / wall_ms_per_iter,
               step_kernel_ms_per_iter=step_ms,
               step_kernel_calls_per_iter=step_calls, top=top)
    print(f"[profile] main-path farm, per farm iteration: device "
          f"{device_ms:.3f} ms in {launches:.1f} kernels, wall "
          f"{wall_ms_per_iter:.2f} ms -> device busy "
          f"{100 * out['device_busy_share']:.1f}%; sp_step kernel "
          f"{step_ms:.3f} ms in {step_calls:.2f} launches [{card}]",
          flush=True)
    for t in top:
        print(f"[profile]   {t['ms_per_iter']:.3f} ms/iter "
              f"{t['calls_per_iter']:.1f} calls/iter  {t['name']}",
              flush=True)
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; nothing was run")
    import spock_tpu_torch
    from spock_tpu_torch.ops import _build

    # ---- 1. environment ----
    card = card_line()
    print(card, flush=True)
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"spock_tpu_torch {spock_tpu_torch.__version__}", flush=True)
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on")
    check(not torch.backends.cudnn.allow_tf32, "TF32 convolutions are on")
    device = torch.device("cuda")

    # ---- 2. build: sp_step compiles beside phase 3 and the _pncost farm
    t0 = time.perf_counter()
    _build.build_all(["cp_sweep", "metric_apply", "prox_h_conj"])
    builder = concurrent.futures.ThreadPoolExecutor(1)
    step_build = builder.submit(_build.build_all)

    @functools.cache
    def built():
        """Waits for every build (a failed one raises) and reports it:
        (seconds to the last library, ptxas summaries)."""
        step_build.result()
        build_s = time.perf_counter() - t0
        for name, (sec, log) in _build.BUILD_LOG.items():
            print(f"[build] {name}: nvcc {sec:.1f} s\n{log.strip()}",
                  flush=True)
        print(f"[build] all kernels ready {build_s:.1f} s after the build "
              "started", flush=True)
        ptxas = {}
        for name, (_, log) in _build.BUILD_LOG.items():
            for entry, info in ptxas_summary(log).items():
                ptxas[entry] = info
                print(f"[ptxas] {name}: {entry}: {info.get('registers')} "
                      f"registers, spill stores {info.get('spill_stores')} / "
                      f"loads {info.get('spill_loads')} bytes, static shared "
                      f"memory {info.get('static_smem')} bytes", flush=True)
        return build_s, ptxas

    # the float64 CPU reference solves run in these workers, stopped on
    # the way out whatever happens
    try:
        with multiprocessing.get_context("spawn").Pool(REF_WORKERS) as pool:
            result = smoke(card, device, pool, built)
    finally:
        builder.shutdown(wait=True)
    print(card, flush=True)
    print(json.dumps({"kernels": result["kernels"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def smoke(card, device, pool, built):
    """Phases 3-7; ``built()`` waits for the step kernels' build.  Returns
    the numbers written to build/chip_smoke.json."""
    from spock_tpu_torch import SuperMannOpts, build
    from spock_tpu_torch.models import server_heat
    from spock_tpu_torch.ops import spstep

    spec = server_heat.make_spec(N=N, nx=NX, d=D)
    data, meta = build(spec, dtype=torch.float32)
    check(data.device.type == "cuda", "build() did not default to the card")

    # ---- 3. kernels against their plain versions ----
    kernels = [prox_kernel_check(data, meta, card)]
    kernels += sweep_kernel_checks(data, meta, card)
    rows = {k["name"]: k for k in kernels}

    rng = np.random.default_rng(0)
    x0 = torch.tensor(rng.uniform(-0.6, 0.6, (B, meta.nx)),
                      dtype=torch.float32, device=device)
    ws = torch.tensor(rng.integers(0, D, size=(COLD_STEPS + WARM_STEPS, B)),
                      device=device)

    # ---- 7d, 7b: the wider class's farms first, whose reference solves
    # then run beside the phases below ----
    opts = SuperMannOpts()
    wide_state = wide_farms(spec, x0, ws, card, device, opts, pool, built)
    build_s, ptxas = built()
    plans = {str(dt): spstep.smem_plan(data, meta, dt)
             for dt in (torch.float32, torch.float64)}
    for dt, plan in plans.items():
        print(f"[ptxas] step kernels, {dt}: {plan['bytes']} bytes of "
              f"dynamic shared memory per block, costates in shared memory "
              f"{plan['costates_in_shared_memory']}, "
              f"{plan['riccati_groups']} Riccati node groups", flush=True)

    # ---- 4a. the main path: the farm on the fused step ----
    res1, res2, nums, farm_iters = farm(data, meta, x0, ws, card, device,
                                        "fused-step", WARM_STEPS)
    nums["retrials_per_farm_iteration"] = check_step_farm(
        nums["launches"], farm_iters, "fused-step")
    ref = submit_reference(pool, spec, res2.xs)

    # ---- 3, step rows: the step kernel on a real carry ----
    step_rows, step_extra = step_kernel_checks(
        data, meta, spec, res2, card, opts,
        mean_lanes=nums["mean_lanes_per_retrial"])
    step_launches(step_rows, nums["launches"])
    kernels += step_rows

    # ---- 4b. the fused sweep (fused_step=False): kernels #3 and #4 ----
    _, _, snums, s_iters = farm(data, meta, x0, ws, card, device,
                                "fused-sweep", WARM_STEPS, fused_step=False)
    scounts = snums["launches"]
    check(scounts["cp_sweep_metric_fused"] >= 1,
          "the fused-sweep farm never launched cp_sweep_metric_fused")
    check(scounts["candidate_sweep_fused"] >= s_iters,
          f"candidate_sweep_fused launched {scounts['candidate_sweep_fused']} "
          f"times in {s_iters} farm iterations")
    check(scounts["sp_step_fused"] == 0 and scounts["sp_step_retrial"] == 0,
          "the fused-sweep farm launched a step kernel")
    for name in ("cp_sweep_metric_fused", "candidate_sweep_fused"):
        rows[name]["launches"] = scounts[name]

    # ---- 4c. the composed path (fused_sweep=False): the prox_h* kernel ----
    _, _, cnums, c_iters = farm(data, meta, x0, ws, card, device, "composed",
                                WARM_STEPS, fused_sweep=False)
    launches = cnums["launches"]["prox_h_conj"]
    check(launches >= c_iters,
          f"prox_h_conj kernel launched {launches} times in {c_iters} farm "
          "iterations")
    check(sum(cnums["launches"][k] for k in cnums["launches"]
              if k != "prox_h_conj") == 0,
          "the composed path launched a sweep or step kernel")
    rows["prox_h_conj"]["launches"] = launches
    print(f"[paths] ms per farm iteration: fused step "
          f"{nums['ms_per_farm_iteration']:.2f}, fused sweep "
          f"{snums['ms_per_farm_iteration']:.2f}, composed "
          f"{cnums['ms_per_farm_iteration']:.2f}; solves/s: "
          f"{nums['solves_per_s']:.2f}, {snums['solves_per_s']:.2f}, "
          f"{cnums['solves_per_s']:.2f} [{card}]", flush=True)

    # ---- 4d/4e. the Solver's paths: cp_sweep_fused, metric_apply_fused ----
    cp, u_cp = solver_run(data, meta, res2, card, "cp solve",
                          "cp_sweep_fused", algorithm="cp", max_iter=CP_CAP)
    rows["cp_sweep_fused"]["launches"] = cp["launches"]["cp_sweep_fused"]
    broyden, u_broyden = solver_run(
        data, meta, res2, card, "broyden solve", "metric_apply_fused",
        max_iter=BROYDEN_CAP, supermann=SuperMannOpts(direction="broyden"))
    rows["metric_apply_fused"]["launches"] = (
        broyden["launches"]["metric_apply_fused"])

    # ---- 5. the solution ----
    sol, u_ref = solution_check(data, meta, spec, res2.xs, ws, card, device,
                                ref)
    err = sol["controls_max_err"]
    solver_controls((("cp solve", u_cp, cp),
                     ("broyden solve", u_broyden, broyden)), u_ref, card)

    # ---- 7. the wider class: kernel rows, Solvers and solutions ----
    wide = wide_checks(wide_state, ws, card, device, opts)
    kernels += wide.pop("rows")
    check(all(k["launches"] for k in kernels),
          "a kernel row has no launches on its path")

    # ---- 6. where the time goes ----
    prof = profile_farm(data, meta, res2, ws, card,
                        nums["ms_per_farm_iteration"])

    result = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                  build_s=build_s, kernels=kernels, step=step_extra,
                  fused_step_farm=nums, fused_sweep_farm=snums,
                  composed_farm=cnums, cp_solve=cp, broyden_solve=broyden,
                  controls_max_err=err, profile=prof, wide=wide,
                  ptxas=ptxas, step_smem=plans)
    os.makedirs("build", exist_ok=True)
    with open(os.path.join("build", "chip_smoke.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
