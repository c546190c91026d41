#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``spock_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. environment: the card's name and power limit (nvidia-smi), the torch and
   CUDA versions, and the TF32 switches, which must be off;
2. build: every kernel under ``spock_tpu_torch/csrc`` (prox_h_conj,
   cp_sweep, metric_apply, sp_step) with nvcc for sm_90a, all started at
   once in the background (cp_sweep and sp_step, whose sweeps take minutes
   of ptxas, in four and two parts), and the native oracle with g++, each
   waited for at its first use: the phases that need only prox_h_conj (its
   row of phase 3, the composed farm of 4c) run during the long builds;
   nvcc and g++ seconds, ptxas registers, spills and shared memory, and the
   node body's shared-memory plans are printed once all are built;
3. each kernel against its plain PyTorch version at the shapes of the main
   path (B = 128 lanes of server_heat N=10 nx=nu=20 d=2, float32), and both
   timed with CUDA events: prox_h_conj, cp_sweep_fused,
   cp_sweep_metric_fused, candidate_sweep_fused (the three on the node body
   of csrc/cp_sweep.cu) and metric_apply_fused (node body, also at the
   Broyden Solver's B = 4) on random inputs; the element bodies of
   csrc/cp_sweep.cu (candidate_sweep_fused) and csrc/metric_apply.cu on
   server_heat N=4 at nx=nu=33, above the node body's 32, driven by two
   Solvers on the sweep kernels (Anderson, Broyden); after 4a, the step
   kernels of csrc/sp_step.cu (the function of both TPU step kernels) on
   a real carry, one fused iteration
   into a solve from the main path's final state, held in float64 and
   timed in float32: sp_step_fused at tau = 1 with the carry's cache
   flags, and sp_step_backtrack (every looping lane's trials at tau =
   beta, beta^2, ... on the zbar and d the tau = 1 launch kept, in one
   launch) on the lanes that launch leaves looping, on the first of them
   alone and on all B lanes; the ptxas report and the shared-memory plan
   of the step kernels are printed after the build;
4. the paths, each driven with every kernel launch count set to 0 just
   before it and read just after:
   a. the main path, ``mpc.simulate_async`` on the fused step in chunks
      of ITERS_PER_LAUNCH farm iterations, each one replay of a CUDA
      graph: the warm-started async MPC farm of B = 128 server_heat chains
      at tol 1e-3 (a cold phase of 2 steps, then a warm phase of 24 steps
      chained from its state), where every SuperMann iteration is one
      sp_step_fused launch and one sp_step_backtrack launch; the chunks,
      the capture's seconds and the iterations after each phase's end are
      printed; then the same two phases eagerly (``iters_per_launch=0``),
      held bitwise equal to the graphed ones, for ms per farm iteration
      and solves/s of both;
   b. the same farm on the fused sweep (``fused_step=False``), where every
      CP sweep is one launch of a sweep kernel (each farm prints its launches
      by kernel and, for csrc/cp_sweep.cu, by body: the node body only);
   c. the same farm on the composed path (``fused_sweep=False``), whose
      prox_h* phase is the prox_h_conj kernel;
   d. ``Solver(algorithm="cp")``, one cp_sweep_fused launch per iteration,
      and e. ``Solver`` with Broyden directions, one metric_apply_fused
      launch per iteration (all on the node body), both warm-started from
      4 lanes of the main path's farm at its final states;
5. the solution: the float32 root controls of a cold 1-step farm on
   the main path (graphed) from the warm phase's states against the native
   float64 oracle (``spock_tpu_torch.baselines.native``, SuperMann, tol
   1e-5, as bench.py's parity check) for 2 lanes, and the controls of 4d
   and 4e at the same states against the same solve;
6. where the time goes: ``torch.profiler`` over 10 eager and 2 graphed
   chunks of warm farm iterations of the main path (device time per
   iteration, kernels per iteration, the device's busy share, the step
   kernels' share, the top kernels, and whether the profiler sees the
   graph replays' kernels), then the main path's line beside the eager
   farm's before its retrials left the host (BEFORE_GRAPHS);
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
      kernel's class has uniform costs; the node body with per-node costs),
      and a CP and a Broyden ``Solver`` warm-started from it (#2, #5);
   e. the solutions: the root controls of the ``_navar`` farm against the
      native oracle, of the ``_pncost`` farm and of its two solves against
      the port's float64 solve on the card (the oracle rejects per-node
      costs), the root polytope rows, and that the polytope binds (the
      oracle's objective with it exceeds the one without it);
8. BASELINE config 3, the risk-measure sweep (``examples/risk_sweep.py``:
   server_heat d=3 nx=nu=6; risk-neutral, AV@R at alpha 0.99, 0.9, 0.5 and
   0.1, TV(0.3) and EVaR(0.5); cold single-lane float32 ``Solver`` solves
   to tol 1e-4), built from the port's own ``server_heat`` and ``risks``:
   a. N=12 (265,720 nodes): each row on its default path, the AV@R, TV and
      risk-neutral rows on the step kernels at B = 1 (one block each, the
      costates in device memory; the six at once, each on a stream and a
      host thread of its own), the EVaR row, whose exponential cone no
      kernel covers, on the composed path with the plain prox_h* and no
      kernel launch (its process's counts), in a worker process beside
      them with 7e's _pncost reference and 8c's float32 solves; every row
      must converge, lie within 3e-2 of the JAX package's CPU float32
      objective (``examples/output/risk_sweep_n12.json``) and keep the risk
      ordering;
   b. AV@R_0.5 at N=12 on the three paths (fused step, sweep kernels,
      composed), ms per iteration and the device's busy share, and the
      step kernels #7 and #6 at B = 1 held against their plain versions
      (float64) and timed (float32) with their bounds (``[cfg3]`` rows);
   c. the seven rows at N=4 (40 nodes) in float32 (solved in a worker
      process beside 8a) against float64 solves at tol 1e-9, the native
      oracle's and, for EVaR, the port's on the host's CPU (both in the
      workers from the start): at tol 1e-4 reported, at tol 1e-5 held,
      root controls within 1e-3 and the objective within 1e-3 relative;
   d. record mode on the headline problem at B = 128: a cold fused-step
      ``run_supermann(record=True)`` and a cold ``run_cp(record=True)``,
      their traces against the final residuals, and one recorded fused
      iteration captured in a CUDA graph and replayed, equal to the eager
      call;
9. BASELINE config 4 (``examples/bigtree_scaling.py``'s: server_heat N=15
   nx=nu=4 d=3, 7,174,453 nodes, the band -2 <= 1'x <= 2 at every node,
   one lane, float32), alone on the card after phase 8:
   a. its build, timed, and the kernels #7 (tau = 1, no cache), #6 (the
      lane made to loop), #4, #3 and #2 at B = 1 on it, each held in
      float64 against its plain version (the kernel's outputs wait on the
      host while the plain version runs) and timed in float32 (median of
      3); the rows carry their kernel's launches on the main path, since
      config 4's own solve launches none;
   b. its cold solve to tol 1e-3 (at most 1000 iterations) through
      ``parallel.bigtree.run_sp_sharded`` on ``parallel.mesh.make_mesh()``,
      a one-rank NCCL group (the partition stage 0: the share is the whole
      tree, the reductions go through NCCL), with the counts set to 0 just
      before and read just after (the composed path: none); iterations, ms
      per iteration, peak device memory, collectives per iteration, the
      band at every node, the device's busy share over 5 profiled
      iterations, and one SuperMann iteration and 20 node-sharded CP
      iterations bitwise against the unsharded ``sp_body`` and ``Solver``;
   c. the headline farm lane-sharded on that mesh (``shard_batch``,
      ``replicate``, ``gather_batch``) on the main path (graphed fused
      step), 2 cold steps, bitwise equal to the unsharded farm.

Each phase prints the seconds since the script started (``[time]``).

The native oracle's library is built by g++ beside the kernels, and its
solves for phases 5, 7e and 8c run on the host's CPU in REF_WORKERS worker
processes, each started as soon as its states are known (8c's, and its
float64 EVaR solve by the port, at the start), so they overlap the card's
phases; the farms of 7d and 7b therefore run as soon as their kernels are
built.  The ``_pncost`` reference (1022 per-node matrices, ~4,000
iterations, which took 819.5 s on the host's CPU) runs on the card, in a
worker process beside phase 8a (7e's checks follow 8a), as do 8a's EVaR
row and 8c's float32 solves: host-bound work that a thread of this process
would hold up.  The reference is the port's plain float64 solve on the
composed path, where no kernel runs for a problem with polytope rows (its
process's launch counts show it).  The workers and the
builds are stopped or waited for when the script ends, whatever happens.

The last lines are the card, one JSON object with a row per kernel, and the
result line ``{"ok": true, "device": {...}}``; the line before the card
gives the whole run's seconds.  Numbers also go to
``build/chip_smoke.json``.  The script imports nothing of JAX.
"""

from __future__ import annotations

import functools
import json
import math
import multiprocessing
import os
import subprocess
import sys
import threading
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
PROFILE_CHUNKS = 2  # graph replays profiled
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
# the native oracle's float64 solves run in worker processes beside the
# card's phases, one core each: per-node AV@R slows their convergence
# (thousands of iterations)
REF_WORKERS, REF_CAP = 4, 10_000
ORACLE, ORACLE_CAP = "the native f64 oracle", 20_000  # bench.py's cap
# the main path's chunk of farm iterations, one CUDA graph replay: a
# multiple of 3, so that every chunk starts at history phase 0
ITERS_PER_LAUNCH = 30
# the main path eagerly, with a host sync per backtracking retrial, before
# the graphed chunks (this script on an NVIDIA H100 80GB HBM3 at 700.00 W):
# ms per farm iteration, kernels per farm iteration, the device's busy
# share, solves/s
BEFORE_GRAPHS = (6.38, 112.2, 0.490, 652.18)
# the element body's row: server_heat N=4 above the node body's 32 states
WIDE_NX, WIDE_N = 33, 4
ELEMENT_CAP = 3000
# BASELINE config 3 (BASELINE.json configs[2]) as examples/risk_sweep.py
# runs it: server_heat d=3 nx=nu=6, risk-neutral, AV@R at the alphas below,
# TV(0.3) and EVaR(0.5), cold single-lane SuperMann solves in float32 to tol
# 1e-4, at most 4000 iterations; N=12 (265,720 nodes) is the config, N=4
# the JAX package's --small size
CFG3_N, CFG3_SMALL_N, CFG3_NX, CFG3_D = 12, 4, 6, 3
CFG3_TOL, CFG3_CAP = 1e-4, 4000
CFG3_ALPHAS = (0.99, 0.9, 0.5, 0.1)
CFG3_TAG = "cfg3"
# the JAX package's objectives of the same rows (CPU, float32): a
# same-problem check (AV@R_0.99 reads 1% below the risk-neutral value
# there), within 3e-2 relative, also the slack of the risk ordering
CFG3_JAX = "examples/output/risk_sweep_n12.json"
CFG3_OBJ_RTOL = 3e-2
# N=4: f32 root controls (absolute) and objective (relative) within 1e-3 of
# float64 solves at tol 1e-9 (the native oracle takes up to ~67,000
# iterations there).  The f32 solves held stop at tol 1e-5: at config 3's
# tol 1e-4 the termination leaves the controls up to ~7e-3 from that
# solution (within 1e-3 at tol 1e-5), so those solves are run and reported
# beside them, not held
CFG3_SMALL_TOL, CFG3_REF_TOL, CFG3_REF_CAP = 1e-3, 1e-9, 1_000_000
CFG3_SMALL_SOLVE_TOL, CFG3_SMALL_CAP = 1e-5, 20_000
CFG3_PATH_ITERS = 30  # iterations of each path's timed run (8b)
CFG3_STEP_REPS = 5  # timed launches of the step kernels at B = 1

# BASELINE config 4 (BASELINE.json configs[3]) as examples/bigtree_scaling.py
# builds it: server_heat N=15 nx=nu=4 d=3, 7,174,453 nodes, the band
# -2 <= 1'x <= 2 at every node, x0 = (0.3, -0.2, 0.1, 0.05), float32, one
# lane; its cold SuperMann solve to tol 1e-3 within 1000 iterations
CFG4_N, CFG4_NX, CFG4_D, CFG4_NODES = 15, 4, 3, 7_174_453
CFG4_X0 = (0.3, -0.2, 0.1, 0.05)
CFG4_BAND, CFG4_BAND_TOL = 2.0, 1e-2  # tests/test_node_sharding.py's check
CFG4_TOL, CFG4_CAP = 1e-3, 1000
CFG4_TAG = "cfg4"
CFG4_REPS = 3  # timed launches of each kernel at B = 1
CFG4_PROFILE_ITERS = 5
CFG4_CP_ITERS = 20
# the node-sharded operators at a split stage on one rank (the stage four
# ranks would split): CFG4_STAGE_CP_ITERS CP iterations and one SuperMann
# iteration against the unsharded ones, each within CFG4_STAGE_RTOL of
# (1 + the largest |value| it compares): f32 roundoff, some 80 units in the
# last place
CFG4_STAGE_RANKS, CFG4_STAGE_CP_ITERS, CFG4_STAGE_RTOL = 4, 5, 1e-5


T0 = time.perf_counter()


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def stamp(phase):
    print(f"[time] {phase} at {time.perf_counter() - T0:.1f} s", flush=True)


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


def to_host(tree):
    """Every tensor of a tree copied to the host (the card's copies are
    freed with the tree)."""
    from spock_tpu_torch.zv import tmap

    return tmap(lambda a: a.cpu() if torch.is_tensor(a) else a, tree)


def hold(name, got, ref, scales=None, rtol=KERNEL_RTOL):
    """max|kernel - plain| over the output leaves; each must lie within
    rtol (1 + scale), scale = max|plain| unless given.  A kernel output
    kept on the host is compared leaf by leaf on the plain version's
    device."""
    from spock_tpu_torch.zv import leaves

    got, ref = leaves(got), leaves(ref)
    check(len(got) == len(ref), f"{name}: {len(got)} outputs, plain {len(ref)}")
    max_err = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        g = g.to(r.device)
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
               nbytes, ops, card, batch=B):
    """One row of the ``kernels`` line; its launches are filled in from the
    path that runs it."""
    bound_ms, bound_by = bound(nbytes, ops)
    print(f"[kernel] {name} B={batch} max_abs_err={max_err:.3e} kernel "
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


def cost_bytes(data):
    """Bytes of the per-node cost matrices (0 where uniform): what a node-body
    pass of L or L' reads from them, per lane."""
    return nbytes_of([a for a in (data.sqrtQ, data.sqrtR, data.sqrtQN)
                      if a.shape[0] != 1])


# passes of L or L' over the cost matrices per lane, by sweep kernel: L' and
# L in the sweep, both again for M r, both again for M d (M alone: 2)
COST_PASSES = {"cp_sweep_fused": 2, "cp_sweep_metric_fused": 4,
               "candidate_sweep_fused": 6}


def sweep_kernel_checks(data, meta, card, tag=None, names=None):
    """Phase 3 (7a with ``tag``): the three whole-sweep kernels (or those in
    ``names``) against their plain versions; the rows are named
    ``name[tag]``.  With per-node costs, prints the cost-matrix bytes a
    launch reads from the L2 and their rate."""
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
    }
    # the kernels read either a cost matrix or its node-minor copy: the
    # constants without the copies
    consts = sweep_kernels._consts(data, meta)[:sweep_kernels.N_CONSTS]
    body = sweep_kernels.sweep_body(meta, data, data.dtype)
    rows = []
    for name, (kernel, plain, inputs) in calls.items():
        if names is not None and name not in names:
            continue
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
        nbytes = nbytes_of(leaves(tuple(inputs)) + leaves(got) + consts)
        ops = B * sweep_ops(meta, name != "cp_sweep_fused",
                            name == "candidate_sweep_fused")
        source, replaces = SWEEP_KERNELS[name]
        rows.append(kernel_row(row_name(name, tag), source, replaces,
                               max_err, time_ms(kernel), time_ms(plain),
                               nbytes, ops, card))
        report_cost_reads(row_name(name, tag), body, COST_PASSES[name],
                          data, B, rows[-1]["ms"], card)
    return rows


def report_cost_reads(name, body, passes, data, batch, ms, card):
    """The body of a launch and, with per-node costs, the cost-matrix bytes
    its L and L' passes read from the L2 and their rate."""
    per_lane = passes * cost_bytes(data)
    print(f"[kernel] {name}: {body} body"
          + (f"; per-node cost matrices read {per_lane / 1e6:.1f} MB a lane, "
             f"{batch * per_lane / 1e9:.2f} GB a launch, "
             f"{batch * per_lane / ms / 1e6:.0f} GB/s" if per_lane else "")
          + f" [{card}]", flush=True)


def metric_kernel_check(data, meta, card, batch=B, tag=None):
    """Phase 3 (7a with ``tag``): metric_apply_fused against
    linop.metric_apply at ``batch`` lanes on random inputs, one launch on the
    body the class takes, timed.  Returns the row (named
    ``metric_apply_fused[tag]``) and the body and grid."""
    from spock_tpu_torch.ops import linop, sweep_kernels
    from spock_tpu_torch.problem import step_size
    from spock_tpu_torch.zv import leaves

    name = row_name("metric_apply_fused", tag)
    rng = np.random.default_rng(1)
    z, v = sweep_kernels.new_pair(meta, batch, lambda s: torch.tensor(
        rng.standard_normal(s), dtype=data.dtype, device=data.device))
    g = step_size(data)

    def kernel():
        return sweep_kernels.metric_apply_fused(data, meta, z, v, g, g)

    def plain():
        return linop.metric_apply(data, meta, z, v, g, g)

    body = sweep_kernels.metric_body(meta, data, data.dtype)
    before = dict(sweep_kernels.LAUNCHES)
    got = kernel()
    torch.cuda.synchronize()
    counts = {k: sweep_kernels.LAUNCHES[k] - before[k]
              for k in before if k.startswith("metric_apply")}
    check(counts["metric_apply_fused"] == 1, f"{name}: launches {counts}")
    check_metric_body(counts, name, body)
    max_err = hold(name, got, plain())
    consts = sweep_kernels._consts(data, meta)[:sweep_kernels.N_LMATS]
    nbytes = nbytes_of(leaves((z, v)) + leaves(got) + consts)
    ops = batch * sweep_ops(meta, True, False, sweep=False)
    source, replaces = SWEEP_KERNELS["metric_apply_fused"]
    row = kernel_row(name, source, replaces, max_err, time_ms(kernel),
                     time_ms(plain), nbytes, ops, card, batch=batch)
    report_cost_reads(name, body, 2, data, batch, row["ms"], card)
    extra = dict(body=body, batch=batch)
    if body == "node":
        extra["grid"] = sweep_kernels.metric_grid(meta, batch)
        print(f"[kernel] {name} B={batch}: grid {extra['grid']} [{card}]",
              flush=True)
    return row, extra


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
    for the backtrack is not counted) and its floating-point operations (the
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
    return nbytes, scal.shape[0] * per_lane


def backtrack_bytes_ops(meta, k, trials, pair_bytes, consts, lanes=B):
    """Bytes and operations of the backtrack of k looping lanes that make
    ``trials`` trials in all: z, d and zbar read and z_new and s written
    once at those lanes (the pair of one lane is pair_bytes / lanes), the
    output scalars of every lane, the constants once; the candidate sweep
    and ~20 operations per value for the commit a trial."""
    nbytes = (5 * k * pair_bytes / lanes + 2 * lanes * 16 * 4
              + nbytes_of(consts))
    return nbytes, trials * (sweep_ops(meta, True, True)
                             + 20 * (meta.nz + meta.nv))


def hold_step(name, got, ref, lanes=None):
    """A step's six pairs (or the backtrack's z_new and s) and its output
    slots 0-12 in float64 against the plain version's, with identical K1 /
    K2 / loop decisions; ``lanes`` picks the rows of the pairs to compare.
    Returns the largest error and the errors by slot."""
    from spock_tpu_torch.zv import tmap

    gs, rs = got[-1].to(ref[-1].device), ref[-1]
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
    - the backtrack (#6) of the lanes that launch leaves looping, each
      making its trials at tau = beta, beta^2, ... on the zbar and d it
      kept, against sp_backtrack_ref, and in float64 one trial of it
      (max_backtracks = 1) also against sp_step_ref with no cache at tau =
      beta on those lanes (from a tau = 1 launch with no cache, so that its
      zbar is the fresh sweep);
    - the backtrack of the first of those lanes alone, and of all B
      lanes.
    Each is held in float64 and timed in float32, where the K1/K2 decisions
    of kernel and plain version are compared lane by lane.  Also times the
    tau = 1 launch with every lane cached and with none.  ``mean_lanes``:
    the farm's mean looping lanes per farm iteration, taken when the carry
    leaves no lane looping.  Rows and messages are named ``name[tag]``."""
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
    consts = sweep_kernels._consts(data, meta)[:sweep_kernels.N_CONSTS]
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

    # ---- the backtrack (#6): the lanes the carry loops on, then one of
    # them alone, then all ----
    looping = torch.nonzero(got64[6][:, spstep.OC_LOOP] > 0.5).flatten()
    if looping.numel() == 0:
        k = max(1, round(mean_lanes or 1))
        looping = torch.nonzero(act).flatten()[:k]
        print(f"[step] the carry leaves no lane looping: the backtrack rows "
              f"take the first {looping.numel()} active lanes", flush=True)
    bt = (opts.beta, opts.max_backtracks)

    def marked(oscal, lanes):
        """The tau = 1 launch's output scalars with ``lanes`` looping."""
        o = oscal.clone()
        o[:, spstep.OC_LOOP] = 0.0
        o[lanes, spstep.OC_LOOP] = 1.0
        return o

    # one trial (max_backtracks = 1) against sp_step_ref with no cache at
    # tau = beta on those lanes, from a tau = 1 launch with no cache (its
    # zbar is the fresh sweep): the function of a trial
    nc64 = inputs(no_cache, ones, torch.float64)
    keep_nc = spstep.sp_step_fused(data64, meta64, *nc64, g64, g64, **knobs)
    tau_bt = torch.full_like(c.r_safe, opts.beta)
    ref_bt = spstep.sp_step_ref(
        data64, meta64, *inputs(no_cache, tau_bt, torch.float64), g64, g64,
        **knobs)
    sc_nc = spstep.sp_step_backtrack(
        data64, meta64, *nc64[:2], keep_nc[7], nc64[9], nc64[10],
        marked(keep_nc[6], looping), keep_nc[0], keep_nc[3], g64, g64,
        opts.beta, 1, **knobs)
    torch.cuda.synchronize()
    fn_err, _ = hold_step(
        row_name("sp_step_backtrack vs sp_step_ref", tag),
        (keep_nc[0], keep_nc[3], sc_nc[looping]),
        (ref_bt[0], ref_bt[3], ref_bt[6][looping]), lanes=looping)
    for label, lanes in (("sp_step_backtrack", looping),
                         ("sp_step_backtrack_one", looping[:1]),
                         ("sp_step_backtrack_all", torch.arange(
                             B, device=looping.device))):
        name = row_name(label, tag)
        # float64: kernel and plain version on the same kept zbar and d
        o64 = marked(got64[6], lanes)
        zk, sk = tmap(torch.clone, got64[0]), tmap(torch.clone, got64[3])
        zr, sr = tmap(torch.clone, got64[0]), tmap(torch.clone, got64[3])
        out64 = spstep.sp_step_backtrack(data64, meta64, *args64[:2],
                                         got64[7], args64[9], args64[10],
                                         o64, zk, sk, g64, g64, *bt, **knobs)
        torch.cuda.synchronize()
        outr, _ = spstep.sp_backtrack_ref(data64, meta64, *args64[:2],
                                          got64[7], args64[9], args64[10],
                                          o64, zr, sr, g64, g64, *bt,
                                          **knobs)
        max_err, slot_err = hold_step(name, (zk, sk, out64), (zr, sr, outr))
        check(torch.equal(out64[:, spstep.OC_TRIALS],
                          outr[:, spstep.OC_TRIALS]),
              f"{name}: float64 trials differ from the plain version")
        # float32, on the float32 launch's keep
        o32 = marked(got[6], lanes)
        zk, sk = tmap(torch.clone, got[0]), tmap(torch.clone, got[3])
        zr, sr = tmap(torch.clone, got[0]), tmap(torch.clone, got[3])
        out32 = spstep.sp_step_backtrack(data, meta, *args[:2], got[7],
                                         args[9], args[10], o32, zk, sk, g,
                                         g, *bt, **knobs)
        outr32, _ = spstep.sp_backtrack_ref(data, meta, *args[:2], got[7],
                                            args[9], args[10], o32, zr, sr,
                                            g, g, *bt, **knobs)
        torch.cuda.synchronize()
        e32 = f32_agreement(name, (zk, sk, out32), (zr, sr, outr32))
        trials = out32[:, spstep.OC_TRIALS]
        n_trials = int(trials.sum())
        extra[name] = dict(f64_slot_max_abs_err=slot_err, **e32,
                           looping_lanes=int(lanes.numel()),
                           trials=n_trials,
                           trials_by_count=torch.bincount(
                               trials[lanes].long()).tolist(),
                           f64_max_abs_err_one_trial_vs_sp_step_ref=fn_err)
        report(name, max_err, slot_err, e32,
               f"{lanes.numel()} looping lanes, {n_trials} trials (tau = "
               f"{opts.beta}^k, up to {opts.max_backtracks}); one trial "
               f"against sp_step_ref with no cache on the carry's looping "
               f"lanes {fn_err:.3e}")
        zt, st = tmap(torch.clone, got[0]), tmap(torch.clone, got[3])

        def kernel(o=o32, zt=zt, st=st):
            return spstep.sp_step_backtrack(data, meta, *args[:2], got[7],
                                            args[9], args[10], o, zt, st, g,
                                            g, *bt, **knobs)

        def plain(o=o32, zt=zt, st=st):
            return spstep.sp_backtrack_ref(data, meta, *args[:2], got[7],
                                           args[9], args[10], o, zt, st, g,
                                           g, *bt, **knobs)

        nbytes, ops = backtrack_bytes_ops(meta, int(lanes.numel()), n_trials,
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
    spstep.reset_retrials()
    for counts in (sweep_kernels.LAUNCHES, spstep.LAUNCHES):
        for k in counts:
            counts[k] = 0


def check_node_body(counts, label, kernels):
    """A farm or solve whose sweep kernels ran the node body only: every
    launch of ``kernels`` (at least one of them) went to it."""
    sweeps = sum(counts[k] for k in kernels)
    check(sweeps >= 1 and counts["cp_sweep_node_body"] == sweeps
          and counts["cp_sweep_element_body"] == 0,
          f"{label}: the sweep kernels' launches by body "
          f"{counts['cp_sweep_node_body']} node, "
          f"{counts['cp_sweep_element_body']} element, for {sweeps} sweeps")


SWEEP_LAUNCHES = ("cp_sweep_fused", "cp_sweep_metric_fused",
                  "candidate_sweep_fused")


def check_metric_body(counts, label, body):
    """A solve whose metric kernel ran ``body`` only, at least once."""
    other = "element" if body == "node" else "node"
    check(counts["metric_apply_fused"] >= 1
          and counts[f"metric_apply_{body}_body"]
          == counts["metric_apply_fused"]
          and counts[f"metric_apply_{other}_body"] == 0,
          f"{label}: metric_apply_fused launched "
          f"{counts['metric_apply_fused']} times, by body "
          f"{counts['metric_apply_node_body']} node, "
          f"{counts['metric_apply_element_body']} element")


def element_body_check(card, device):
    """Phase 3, the element bodies: candidate_sweep_fused and
    metric_apply_fused against their plain versions on server_heat
    N=WIDE_N at nx = nu = WIDE_NX (above the node body's 32), then two cold
    4-lane Solvers on that problem, which run SuperMann on the sweep kernels
    (the step kernels stop at 32 states too), with Anderson and with Broyden
    directions, each with the launch counts set to 0 just before and read
    just after.  Returns the two rows (their launches from the solves) and
    the solves' numbers."""
    from spock_tpu_torch import SuperMannOpts, build
    from spock_tpu_torch.algorithms import supermann as sp
    from spock_tpu_torch.models import server_heat
    from spock_tpu_torch.ops import sweep_kernels
    from spock_tpu_torch.solver import Solver

    spec = server_heat.make_spec(N=WIDE_N, nx=WIDE_NX, d=D)
    data, meta = build(spec, dtype=torch.float32, device=device)
    check(sweep_kernels.sweep_body(meta, data, data.dtype) == "element"
          and sweep_kernels.metric_body(meta, data, data.dtype) == "element"
          and not sp.use_fused_step(data, meta, sp.SuperMannOpts()),
          f"nx={WIDE_NX}: not on the element bodies of the sweep kernels")
    tag = f"nx{WIDE_NX}"
    row, = sweep_kernel_checks(data, meta, card, tag=tag,
                               names=("candidate_sweep_fused",))
    mrow, _ = metric_kernel_check(data, meta, card, tag=tag)
    rng = np.random.default_rng(2)
    x0 = torch.tensor(rng.uniform(-0.6, 0.6, (SOLVE_LANES, meta.nx)),
                      dtype=torch.float32, device=device)
    out = {}
    for label, opts in (("anderson", SuperMannOpts()),
                        ("broyden", SuperMannOpts(direction="broyden"))):
        reset_counts()
        t0 = time.perf_counter()
        res = Solver(data, meta, max_iter=ELEMENT_CAP, device=device,
                     supermann=opts).solve(x0, tol=TOL)
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = launch_counts()
        iters = res.iterations.cpu().numpy()
        check(bool(res.converged.all()), f"{tag} {label} solve did not "
              f"converge: iterations {iters.tolist()}")
        sweeps = sum(counts[k] for k in SWEEP_LAUNCHES)
        check(counts["candidate_sweep_fused"] >= int(iters.max())
              and counts["cp_sweep_element_body"] == sweeps
              and counts["cp_sweep_node_body"] == 0,
              f"{tag} {label} solve: launches {counts}")
        if label == "broyden":
            check_metric_body(counts, f"{tag} broyden solve", "element")
            mrow["launches"] = counts["metric_apply_fused"]
        else:
            row["launches"] = counts["candidate_sweep_fused"]
        print(f"[{tag} {label} solve] {SOLVE_LANES} lanes cold: iterations "
              f"{iters.tolist()} in {wall_s:.2f} s; sweep launches by body: "
              f"element {counts['cp_sweep_element_body']}, node "
              f"{counts['cp_sweep_node_body']}; metric launches by body: "
              f"element {counts['metric_apply_element_body']}, node "
              f"{counts['metric_apply_node_body']} [{card}]", flush=True)
        out[label] = dict(iterations=iters.tolist(), wall_s=wall_s,
                          launches=counts)
    return [row, mrow], out


def check_step_farm(counts, farm_iters, label):
    """A farm on the fused step: one sp_step_fused and one sp_step_backtrack
    launch per farm iteration run (``farm_iters``, those after the farm's
    end in its last graphed chunk included), no other kernel."""
    for name in ("sp_step_fused", "sp_step_backtrack"):
        check(counts[name] == farm_iters,
              f"{label}: {name} launched {counts[name]} times in "
              f"{farm_iters} farm iterations")
    others = {k: c for k, c in counts.items()
              if k not in ("sp_step_fused", "sp_step_backtrack")}
    check(not any(others.values()),
          f"the {label} farm launched other kernels: {others}")


def step_launches(rows, counts):
    """The launches of the step rows on their farm: the tau = 1 row's, then
    the backtrack kernel's for the backtrack rows."""
    rows[0]["launches"] = counts["sp_step_fused"]
    for row in rows[1:]:
        row["launches"] = counts["sp_step_backtrack"]


def check_bitwise(label, got, want):
    """Two farm results bitwise equal."""
    from spock_tpu_torch.zv import leaves

    check(got.total_iterations == want.total_iterations,
          f"{label}: {got.total_iterations} farm iterations, eager "
          f"{want.total_iterations}")
    fields = ("steps_done", "iters_per_step", "us", "xs")
    for name, a, b in (
            [(f, getattr(got, f), getattr(want, f)) for f in fields]
            + [(f"z/v leaf {i}", a, b) for i, (a, b) in enumerate(zip(
                leaves((got.z, got.v)), leaves((want.z, want.v))))]):
        check(torch.equal(a, b), f"{label}: {name} differs from the eager "
              f"farm's by {abs_err(a.double(), b.double())}")


def main_path_line(nums, prof, card):
    """The main path's four numbers beside BEFORE_GRAPHS': ms per farm
    iteration, kernels per farm iteration, the device's busy share and
    solves/s."""
    g = prof.get("graphed") if prof else None
    e = prof.get("eager") if prof else None

    def fmt(d, key, scale=1.0, f=".3f"):
        return "not measured" if d is None else format(scale * d[key], f)

    print(f"[main path] graphed chunks of {ITERS_PER_LAUNCH}: "
          f"{nums['ms_per_farm_iteration']:.3f} ms per farm iteration, "
          f"{fmt(g, 'device_kernels_per_iter', f='.1f')} kernels per farm "
          f"iteration, device busy "
          f"{fmt(g, 'device_busy_share', 100.0, '.1f')}%, "
          f"{nums['solves_per_s']:.2f} solves/s; eager in this run "
          f"{nums['eager']['ms_per_farm_iteration']:.3f} ms, "
          f"{fmt(e, 'device_kernels_per_iter', f='.1f')} kernels, busy "
          f"{fmt(e, 'device_busy_share', 100.0, '.1f')}%, "
          f"{nums['eager']['solves_per_s']:.2f} solves/s; before (eager, "
          f"a host sync per retrial): {BEFORE_GRAPHS[0]} ms, "
          f"{BEFORE_GRAPHS[1]} kernels, {100 * BEFORE_GRAPHS[2]:.1f}%, "
          f"{BEFORE_GRAPHS[3]} solves/s [{card}]", flush=True)


def farm(data, meta, x0, ws, card, device, label, warm_steps, **path):
    """Phase 4a-4c: cold then warm async farm on the path given by the
    ``fused_sweep``/``fused_step``/``iters_per_launch`` switches in
    ``path``, with the launch counts set to 0 just before and read just
    after.  Returns both results, the numbers of the run and the farm
    iterations it ran (in graphed chunks, those after each phase's end
    included: every one launched its kernels)."""
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
    cold_run = res1.run
    check(bool((res1.steps_done == COLD_STEPS).all()),
          f"{label} cold phase incomplete after {res1.total_iterations} farm "
          f"iterations: steps_done={res1.steps_done.tolist()}")
    t0 = time.perf_counter()
    res2 = mpc.simulate_async(data, meta, res1.xs, ws, TOL, n_steps=warm_steps,
                              max_total_iters=WARM_CAP, z0=res1.z, v0=res1.v,
                              device=device, **path)
    sync()
    warm_s = time.perf_counter() - t0
    warm_run = res2.run
    counts = launch_counts()
    looped, trials = spstep.retrials()
    check(bool((res2.steps_done == warm_steps).all()),
          f"{label} warm phase incomplete after {res2.total_iterations} farm "
          f"iterations: steps_done={res2.steps_done.tolist()}")
    iters = res2.iters_per_step[:warm_steps].double().cpu().numpy()
    farm_iters = cold_run["executed"] + warm_run["executed"]
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
        # per iteration run, those after the phase's end included
        ms_per_farm_iteration_run=1e3 * warm_s / warm_run["executed"],
        farm_iterations_run=farm_iters,
        cold_run=cold_run,
        warm_run=warm_run,
        launches=counts,
        launches_per_farm_iteration={k: c / farm_iters
                                     for k, c in counts.items()},
        looping_lanes_per_farm_iteration=looped / farm_iters,
        trials_per_looping_lane=trials / looped if looped else 0.0,
    )
    print(f"[{label} farm] cold {COLD_STEPS} steps: "
          f"{res1.total_iterations} farm iterations in {cold_s:.2f} s; warm "
          f"{warm_steps} steps: {res2.total_iterations} farm iterations in "
          f"{warm_s:.2f} s -> {nums['solves_per_s']:.2f} solves/s, mean "
          f"{nums['mean_iters_per_solve']:.2f} / p99 {nums['p99_iters']:.1f} "
          f"iterations per solve, {nums['ms_per_farm_iteration']:.2f} ms per "
          f"farm iteration [{card}]", flush=True)
    if warm_run["iters_per_launch"]:
        print(f"[{label} farm] iters_per_launch "
              f"{warm_run['iters_per_launch']}, graphed "
              f"{warm_run['graphed']}: cold {cold_run['chunks']} graph "
              f"replays + {cold_run['eager_chunks']} eager chunks, "
              f"{cold_run['wasted']} iterations after its end; warm "
              f"{warm_run['chunks']} + {warm_run['eager_chunks']}, "
              f"{warm_run['wasted']} after its end; captures "
              f"{cold_run['captures'] + warm_run['captures']} in "
              f"{cold_run['capture_s'] + warm_run['capture_s']:.3f} s, "
              f"warm-up {cold_run['warmup_s'] + warm_run['warmup_s']:.3f} s "
              f"[{card}]", flush=True)
    per = ", ".join(f"{k} {c} ({c / farm_iters:.2f}/iter)"
                    for k, c in counts.items() if c)
    print(f"[{label} farm] launches over {farm_iters} farm iterations run: "
          f"{per}" + (f"; {looped} lanes backtracked "
                      f"({nums['looping_lanes_per_farm_iteration']:.2f} per "
                      f"farm iteration), {trials} trials "
                      f"({nums['trials_per_looping_lane']:.2f} per lane)"
                      if counts["sp_step_backtrack"] else ""),
          flush=True)
    return res1, res2, nums, farm_iters


def reference_solve(spec, xs):
    """The port's float64 solve (plain versions, composed iteration, tol
    1e-5) from the states xs [lanes, nx] (numpy) on the card, on the
    composed path (``fused_sweep=False``), where no kernel runs for a
    problem with polytope rows (checked): the reference of ``_pncost``,
    whose per-node costs the native oracle rejects.  Returns (root
    controls, objectives, seconds, iterations, converged)."""
    from spock_tpu_torch import build
    from spock_tpu_torch.solver import Solver

    t0 = time.perf_counter()
    check(spec.polytope is not None, "a reference solve on the card needs "
          "polytope rows, which keep every kernel out of it")
    reset_counts()
    data64, meta64 = build(spec, dtype=torch.float64, device="cuda")
    ref = Solver(data64, meta64, algorithm="spock", max_iter=REF_CAP,
                 device="cuda", fused_step=False, fused_sweep=False).solve(
                     torch.tensor(xs, device="cuda"), tol=1e-5)
    counts = launch_counts()
    check(not any(counts.values()),
          f"the reference solve on the card launched kernels: {counts}")
    return (ref.z.u[:, :, 0].cpu().numpy(), ref.z.s[:, 0].cpu().numpy(),
            time.perf_counter() - t0, ref.iterations.tolist(),
            bool(ref.converged.all()))


def oracle_solve(spec, xs, tol=1e-5, max_iter=ORACLE_CAP):
    """The native C++ oracle (``spock_tpu_torch.baselines.native``: float64
    on one CPU core, SuperMann + Anderson, tol 1e-5 unless told otherwise, a
    cold solve per state, as bench.py's parity check) from each of the
    states xs [lanes, nx] (numpy), in a worker process.  Returns (root
    controls, objectives, seconds, iterations, converged)."""
    from spock_tpu_torch.baselines.native import NativeSolver

    t0 = time.perf_counter()
    ns = NativeSolver(spec)
    res = [ns.solve(x, tol=tol, max_iter=max_iter, algorithm="spock",
                    warm_start=False) for x in xs]
    return (np.stack([r["u"][0] for r in res]),
            np.array([r["objective"] for r in res]),
            time.perf_counter() - t0, [r["iterations"] for r in res],
            all(r["converged"] for r in res))


def check_states(xs):
    """The first CHECK_LANES states of xs, in float64 numpy."""
    return xs[:CHECK_LANES].double().cpu().numpy()


def submit_oracle(pool, spec, xs):
    """Start :func:`oracle_solve` in a worker from the check states."""
    return pool.apply_async(oracle_solve, (spec, check_states(xs)))


def reference(job, label):
    """The result of a reference solve (submitted, or done: a tuple), which
    must converge."""
    u, obj, seconds, iters, ok = job if isinstance(job, tuple) else job.get()
    check(ok, f"{label}: float64 reference did not converge: iterations "
          f"{iters}")
    return u, obj, seconds, iters


def solution_check(data, meta, spec, xs, ws, card, device, ref, ref_name,
                   tag=None, ref_free=None, **path):
    """Phase 5 (7e with ``tag``): f32 root controls of a cold 1-step farm on
    the configuration's default path (or ``path``) against the float64
    solve ``ref`` (submitted from the same states; ``ref_name`` names it:
    the native oracle, or the port's float64 solve on the card).  With a
    polytope, also the root rows of the f32 controls, and with ``ref_free``
    (the solve without the polytope) whether the polytope binds: the
    float64 objective with it exceeds the one without it by BIND_MARGIN at
    one of the check states.  Returns the numbers and the reference
    controls."""
    from spock_tpu_torch import mpc

    label = row_name("solution", tag)
    res = mpc.simulate_async(data, meta, xs, ws, TOL, n_steps=1,
                             max_total_iters=COLD_CAP, device=device, **path)
    check(bool((res.steps_done == 1).all()), f"{label}: cold 1-step farm "
          "incomplete")
    u_f32 = res.us[0, :CHECK_LANES].double().cpu().numpy()
    u_ref, obj, ref_s, ref_iters = reference(ref, label)
    err = float(np.abs(u_f32 - u_ref).max())
    print(f"[{label}] controls_max_err={err:.3e} over {CHECK_LANES} lanes "
          f"(f32 card farm{' in graphed chunks' if path else ''} vs "
          f"{ref_name}: {ref_iters} iterations in {ref_s:.1f} s, limit "
          f"{CONTROLS_TOL}) [{card}]", flush=True)
    out = dict(controls_max_err=err, reference=ref_name, reference_s=ref_s,
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
    kernels, once they are built, and, once every kernel is (``built()``),
    the ``_navar`` farm on the fused step, followed by the submission of its
    native-oracle solves (with and without the polytope).  Returns their
    state."""
    import dataclasses

    from spock_tpu_torch import build
    from spock_tpu_torch.algorithms import supermann as sp
    from spock_tpu_torch.ops import _build, spstep, sweep_kernels

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
    _build.build_all(["cp_sweep"])
    _, w.res2_p, w.pnums, p_iters = farm(
        w.data_p, w.meta_p, x0, ws, card, device, f"{PNCOST} fused-sweep",
        WARM_STEPS)
    pcounts = w.pnums["launches"]
    check(pcounts["cp_sweep_metric_fused"] >= 1
          and pcounts["candidate_sweep_fused"] >= p_iters,
          f"{PNCOST}: the farm's sweep launches {pcounts} in {p_iters} farm "
          "iterations")
    check(pcounts["sp_step_fused"] == 0 and pcounts["sp_step_backtrack"] == 0
          and pcounts["prox_h_conj"] == 0,
          f"{PNCOST}: the farm launched the step or prox kernel")
    check_node_body(pcounts, f"{PNCOST} farm", SWEEP_LAUNCHES)
    built()

    # 7b. the _navar farm on the fused step: sp_step_fused alone
    _, w.res2_n, w.nnums, w.n_iters = farm(
        w.data_n, w.meta_n, x0, ws, card, device, f"{NAVAR} fused-step",
        WARM_STEPS)
    check_step_farm(w.nnums["launches"], w.n_iters, NAVAR)
    w.ref_n = submit_oracle(pool, w.spec_n, w.res2_n.xs)
    w.ref_free = submit_oracle(
        pool, dataclasses.replace(w.spec_n, polytope=None), w.res2_n.xs)
    return w


def wide_checks(w, ws, card, device, opts):
    """Phases 7a, 7c and the Solvers of 7d on the state of
    :func:`wide_farms`; 7e (:func:`wide_solutions`) waits for the
    ``_pncost`` reference.  Returns the numbers, with the kernel rows (their
    launches from the path that ran them) under "rows"."""
    from spock_tpu_torch import SuperMannOpts

    # 7a. kernels #2-#5 on all three widenings at once
    prow = {r["name"]: r for r in sweep_kernel_checks(
        w.data_p, w.meta_p, card, tag=PNCOST)}
    mrow, mextra = metric_kernel_check(w.data_p, w.meta_p, card, tag=PNCOST)
    prow[mrow["name"]] = mrow
    for name in ("cp_sweep_metric_fused", "candidate_sweep_fused"):
        prow[row_name(name, PNCOST)]["launches"] = w.pnums["launches"][name]

    # 7c. the step kernel on a real _navar carry
    nrows, nextra = step_kernel_checks(
        w.data_n, w.meta_n, w.spec_n, w.res2_n, card, opts, tag=NAVAR,
        mean_lanes=w.nnums["looping_lanes_per_farm_iteration"])
    step_launches(nrows, w.nnums["launches"])

    # 7d. the Solvers warm-started from the _pncost farm: #2 and #5
    cp, u_cp = solver_run(w.data_p, w.meta_p, w.res2_p, card,
                          f"cp solve [{PNCOST}]", "cp_sweep_fused",
                          algorithm="cp", max_iter=CP_CAP)
    check_node_body(cp["launches"], f"cp solve [{PNCOST}]", SWEEP_LAUNCHES)
    prow[row_name("cp_sweep_fused", PNCOST)]["launches"] = (
        cp["launches"]["cp_sweep_fused"])
    broyden, u_broyden = solver_run(
        w.data_p, w.meta_p, w.res2_p, card, f"broyden solve [{PNCOST}]",
        "metric_apply_fused", max_iter=BROYDEN_CAP,
        supermann=SuperMannOpts(direction="broyden"))
    check_metric_body(broyden["launches"], f"broyden solve [{PNCOST}]",
                      "node")
    mrow["launches"] = broyden["launches"]["metric_apply_fused"]

    return dict(rows=list(prow.values()) + nrows, navar_step=nextra,
                pncost_metric=mextra, pncost_cp_solve=cp,
                pncost_broyden_solve=broyden, u_cp=u_cp,
                u_broyden=u_broyden)


def wide_solutions(w, wide, ws, card, device, ref_p):
    """Phase 7e: the solutions of the wider class, against the native
    oracle (``_navar``, run in the worker pool) and the port's float64
    solve on the card (``ref_p``, ``_pncost``: the oracle rejects per-node
    costs), and the controls of 7d's Solvers."""
    cp, broyden = wide["pncost_cp_solve"], wide["pncost_broyden_solve"]
    nsol, _ = solution_check(w.data_n, w.meta_n, w.spec_n, w.res2_n.xs, ws,
                             card, device, w.ref_n, ORACLE, tag=NAVAR,
                             ref_free=w.ref_free)
    psol, u_ref = solution_check(w.data_p, w.meta_p, w.spec_p, w.res2_p.xs,
                                 ws, card, device, ref_p,
                                 "the port's f64 solve on the card",
                                 tag=PNCOST)
    solver_controls(((f"cp solve [{PNCOST}]", wide.pop("u_cp"), cp),
                     (f"broyden solve [{PNCOST}]", wide.pop("u_broyden"),
                      broyden)), u_ref, card)
    print(f"[paths] ms per farm iteration: {NAVAR} fused step "
          f"{w.nnums['ms_per_farm_iteration']:.2f}, {PNCOST} fused sweep "
          f"{w.pnums['ms_per_farm_iteration']:.2f}; solves/s "
          f"{w.nnums['solves_per_s']:.2f}, {w.pnums['solves_per_s']:.2f} "
          f"[{card}]", flush=True)
    wide.update(navar_farm=w.nnums, navar_solution=nsol,
                pncost_farm=w.pnums, pncost_solution=psol)
    return wide


def profile_farm(data, meta, res2, ws, card, wall_ms):
    """Phase 6: device time and kernel mix of warm farm iterations on the
    main path, PROFILE_ITERS of them eagerly and PROFILE_CHUNKS graph
    replays (a measurement: a profiler that sees no device time reports
    "not measured"), per farm iteration run (a graphed chunk may run
    iterations after the farm's end).  ``wall_ms``: {"eager": ms,
    "graphed": ms} per farm iteration run in the unprofiled warm phases."""
    from torch.profiler import ProfilerActivity, profile

    from spock_tpu_torch import mpc

    def run(iters, k):
        return mpc.simulate_async(
            data, meta, res2.xs, ws, TOL, n_steps=ws.shape[0],
            max_total_iters=iters, z0=res2.z, v0=res2.v, iters_per_launch=k)

    out = {}
    for label, iters, k in (
            ("eager", PROFILE_ITERS, 0),
            ("graphed", PROFILE_CHUNKS * ITERS_PER_LAUNCH, ITERS_PER_LAUNCH)):
        run(iters, k)  # same path once more, outside the profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res = run(iters, k)
            torch.cuda.synchronize()
        check(res.run["captures"] == 0
              and res.run["chunks"] == (PROFILE_CHUNKS if k else 0),
              f"profile of the {label} farm: {res.run}")
        n = res.run["executed"]
        kernels = []
        for e in prof.key_averages():
            if str(getattr(e, "device_type", "")).endswith("CUDA"):
                us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
                kernels.append((us, e.count, e.key))
        kernels.sort(reverse=True)
        device_ms = sum(k_[0] for k_ in kernels) / 1e3 / n
        launches = sum(k_[1] for k_ in kernels) / n
        if device_ms <= 0:
            print(f"[profile] {label} farm: device time not measured (the "
                  f"profiler saw no kernel) [{card}]", flush=True)
            out[label] = None
            continue
        top = [dict(name=k_[2][:80], ms_per_iter=k_[0] / 1e3 / n,
                    calls_per_iter=k_[1] / n) for k_ in kernels[:8]]
        step = [k_ for k_ in kernels if "sp_step_kernel" in k_[2]
                or "sp_backtrack_kernel" in k_[2]]
        step_ms = sum(k_[0] for k_ in step) / 1e3 / n
        step_calls = sum(k_[1] for k_ in step) / n
        out[label] = dict(iterations=n, device_ms_per_iter=device_ms,
                          device_kernels_per_iter=launches,
                          wall_ms_per_iter_unprofiled=wall_ms[label],
                          device_busy_share=device_ms / wall_ms[label],
                          step_kernel_ms_per_iter=step_ms,
                          step_kernel_calls_per_iter=step_calls, top=top)
        print(f"[profile] main-path farm, {label}, per farm iteration over "
              f"{n}: device {device_ms:.3f} ms in {launches:.1f} kernels, "
              f"wall {wall_ms[label]:.3f} ms -> device busy "
              f"{100 * out[label]['device_busy_share']:.1f}%; step kernels "
              f"{step_ms:.3f} ms in {step_calls:.2f} launches [{card}]",
              flush=True)
        for t in top:
            print(f"[profile]   {t['ms_per_iter']:.3f} ms/iter "
                  f"{t['calls_per_iter']:.1f} calls/iter  {t['name']}",
                  flush=True)
    out["graph_kernels_seen"] = out["graphed"] is not None
    print(f"[profile] torch.profiler sees the graph replays' kernels: "
          f"{out['graph_kernels_seen']} [{card}]", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 8: BASELINE config 3, the risk-measure sweep
# ---------------------------------------------------------------------------


def cfg3_rows(n_stages):
    """Config 3's seven rows [(name, spec)] at depth ``n_stages`` and its
    initial state, made as examples/risk_sweep.py makes them: the port's
    server_heat and risks, p and x0 from default_rng(0)."""
    import dataclasses

    from spock_tpu_torch import risks
    from spock_tpu_torch.models import server_heat

    base = server_heat.make_spec(N=n_stages, nx=CFG3_NX, d=CFG3_D)
    nnl = base.tree.n_nonleaf
    rng = np.random.default_rng(0)
    p = risks.rand_probvec(rng, CFG3_D)
    x0 = rng.uniform(-0.5, 0.5, CFG3_NX)
    sweep = [("risk_neutral", risks.risk_neutral(p, nnl))]
    sweep += [(f"avar[{a}]", risks.avar(p, a, nnl)) for a in CFG3_ALPHAS]
    sweep += [("tv[0.3]", risks.total_variation(p, 0.3, nnl)),
              ("evar[0.5]", risks.evar(p, 0.5, nnl))]
    return [(name, dataclasses.replace(base, risk=r)) for name, r in sweep], x0


def cfg3_path(data, meta, opts):
    """The path a default Solver takes for a row: the step kernels, or (a
    class no kernel covers) the composed iteration with the plain prox_h*."""
    from spock_tpu_torch.algorithms import supermann as sp
    from spock_tpu_torch.ops import cuda_kernels, sweep_kernels

    if sp.use_fused_step(data, meta, opts):
        return "fused step"
    check(not sweep_kernels.supported(meta, data)
          and not cuda_kernels.supported(meta),
          "a config 3 row outside the step kernels' class would take a "
          "sweep or prox kernel")
    return "composed, plain"


def cfg3_solve(data, meta, x0, out, tol=CFG3_TOL, max_iter=CFG3_CAP,
               **solver_kw):
    """One cold single-lane Solver solve on a stream of its own (a thread's
    work): fills ``out`` with the result and its wall seconds, or the
    exception it raised."""
    from spock_tpu_torch.solver import Solver

    try:
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.default_stream())
        with torch.cuda.stream(stream):
            t0 = time.perf_counter()
            res = Solver(data, meta, algorithm="spock", max_iter=max_iter,
                         **solver_kw).solve(
                torch.tensor(x0, dtype=data.dtype, device=data.device),
                tol=tol)
            stream.synchronize()
            out.update(res=res, wall_s=time.perf_counter() - t0)
    except Exception as exc:  # re-raised by the caller
        out["error"] = exc


def cfg3_nums(res, wall_s, path):
    """A row's numbers from its SolveResult (a single lane)."""
    iters = int(res.iterations)
    return dict(objective=float(res.z.s[0]), iterations=iters,
                converged=bool(res.converged), wall_s=wall_s,
                ms_per_iteration=1e3 * wall_s / max(iters, 1), path=path)


def cfg3_row_line(name, nums, card, note=""):
    print(f"[cfg3] {name}: objective {nums['objective']:.6f}, "
          f"{nums['iterations']} iterations, converged {nums['converged']}, "
          f"{nums['wall_s']:.2f} s, {nums['ms_per_iteration']:.2f} ms per "
          f"iteration, {nums['path']}{note} [{card}]", flush=True)


def cfg3_evar_row():
    """8a's EVaR row at N = 12 in a worker process of its own (its host
    work, ~95% of its time, then overlaps the main process's step-kernel
    rows): a cold f32 Solver solve on its default path, with the process's
    launch counts set to 0 just before and read just after.  Returns its
    numbers and those counts."""
    from spock_tpu_torch import SuperMannOpts, build

    rows, x0 = cfg3_rows(CFG3_N)
    data, meta = build(dict(rows)["evar[0.5]"], dtype=torch.float32)
    path = cfg3_path(data, meta, SuperMannOpts())
    r = {}
    reset_counts()
    cfg3_solve(data, meta, x0, r)
    if "error" in r:
        raise r["error"]
    counts = launch_counts()
    return dict(cfg3_nums(r["res"], r["wall_s"], path), launches=counts)


def wall_ms(fn, reps=5):
    """Median host milliseconds of ``fn()`` up to the card's end of it: the
    time of an eager call, host launches included."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def exp_cone_share(data, meta, row, card):
    """The EVaR row's exponential-cone projection (PyTorch operators, eager
    as in the JAX package) against its plain prox_h* and its iteration, at
    B = 1 on random dual values: ms per call (host clock, to the card's
    end) and the lower bound of its share of an iteration, which makes at
    least two prox_h* calls (the fresh sweep and the candidate's)."""
    from spock_tpu_torch.ops import cuda_kernels, prox
    from spock_tpu_torch.ops.cones import project_cone_product
    from spock_tpu_torch.problem import step_size
    from spock_tpu_torch.zv import Dual

    g = torch.Generator(device=data.device).manual_seed(0)
    v = Dual(**{k: torch.randn(sh, generator=g, device=data.device,
                               dtype=data.dtype)
                for k, sh in cuda_kernels.block_shapes(meta, 1).items()})
    sigma = step_size(data)
    proj_ms = wall_ms(lambda: project_cone_product(v.y, meta.dual_cone))
    prox_ms = wall_ms(lambda: prox.prox_h_conj(data, meta, v, sigma))
    share = 2 * proj_ms / row["ms_per_iteration"]
    print(f"[cfg3] evar[0.5]: the cone projection of y (exp-dual, "
          f"{meta.tree.n_nonleaf} nodes) {proj_ms:.2f} ms per call, the "
          f"plain prox_h* {prox_ms:.2f} ms, an iteration "
          f"{row['ms_per_iteration']:.2f} ms: the projection at least "
          f"{100 * share:.0f}% of it [{card}]", flush=True)
    return dict(exp_projection_ms=proj_ms, prox_h_conj_ms=prox_ms,
                exp_projection_share_min=share)


def risk_sweep(card, opts, evar_job):
    """8a: config 3 at N = 12, seven cold f32 Solver solves at tol 1e-4 on
    each row's default path.  The six rows on the step kernels at once,
    each on a stream and a host thread of its own (one block of the card
    each): the launches in that window must be exactly one sp_step_fused
    and one sp_step_backtrack per iteration of those rows.  The EVaR row
    (``evar_job``: :func:`cfg3_evar_row`, submitted to a worker process)
    runs beside them and must launch no kernel; its cone projection is then
    timed here (:func:`exp_cone_share`), alone.  Holds convergence, the
    objectives against the JAX package's CPU f32 objectives (CFG3_JAX,
    within CFG3_OBJ_RTOL) and the ordering of the risk measures.  Returns
    the numbers and the step kernels' launches."""
    from spock_tpu_torch import build

    rows, x0 = cfg3_rows(CFG3_N)
    with open(CFG3_JAX) as f:
        jax_rows = {r["risk"]: r for r in json.load(f)["rows"]}
    built = []
    for name, spec in rows:
        data, meta = build(spec, dtype=torch.float32)
        built.append((name, data, meta, cfg3_path(data, meta, opts)))
    t = rows[0][1].tree
    print(f"[cfg3] server_heat N={CFG3_N} d={CFG3_D} nx=nu={CFG3_NX}: "
          f"{t.n} nodes, {t.n_nonleaf} non-leaf; paths "
          f"{ {n: p for n, _, _, p in built} } [{card}]", flush=True)
    check(t.n == 265720 and t.n_nonleaf == 88573, "config 3's tree")
    sizes = {n: (m.ny, m.nz + m.nv) for n, _, m, _ in built}
    print("[cfg3] a lane's (z, v) pair by row (ny, floats, MB in f32): "
          + ", ".join(f"{n} ({ny}, {k}, {4 * k / 1e6:.1f})"
                      for n, (ny, k) in sizes.items()), flush=True)
    torch.cuda.synchronize()
    # the step-kernel rows at once
    krows = [b for b in built if b[3] == "fused step"]
    results = {b[0]: {} for b in krows}
    threads = [threading.Thread(target=cfg3_solve,
                                args=(b[1], b[2], x0, results[b[0]]))
               for b in krows]
    reset_counts()
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    conc_s = time.perf_counter() - t0
    counts = launch_counts()
    for name, r in results.items():
        if "error" in r:
            raise r["error"]
    total = sum(int(r["res"].iterations) for r in results.values())
    expect = {k: 0 for k in counts}
    expect.update(sp_step_fused=total, sp_step_backtrack=total)
    check(counts == expect, f"the step-kernel rows launched {counts}, "
          f"expected {expect}")
    out = {}
    for name, _, _, path in krows:
        r = results[name]
        out[name] = cfg3_nums(r["res"], r["wall_s"], path)
        cfg3_row_line(name, out[name], card,
                      f" (one of {len(krows)} rows at once); launches "
                      f"{out[name]['iterations']} sp_step_fused + "
                      f"{out[name]['iterations']} sp_step_backtrack")
    print(f"[cfg3] the {len(krows)} step-kernel rows at once took "
          f"{conc_s:.1f} s: {total} iterations, launches {counts} [{card}]",
          flush=True)
    # the EVaR row, from its worker
    evar = evar_job.get()
    (name, data, meta, path), = [b for b in built if b[3] != "fused step"]
    check(evar["path"] == path, f"the {name} row took {evar['path']}")
    check(not any(evar["launches"].values()),
          f"the {name} row launched kernels: {evar['launches']}")
    cfg3_row_line(name, evar, card, " (in a worker process, beside the "
                  "step-kernel rows); launches 0 (all kernels)")
    out[name] = dict(evar, **exp_cone_share(data, meta, evar, card))
    # the checks
    for name, nums in out.items():
        ref = jax_rows[name]["objective"]
        nums["jax_cpu_f32_objective"] = ref
        nums["rel_to_jax"] = abs(nums["objective"] - ref) / abs(ref)
        print(f"[cfg3] {name}: objective {nums['objective']:.6f} vs the JAX "
              f"package's {ref} ({CFG3_JAX}, CPU f32, "
              f"{jax_rows[name]['iters']} iterations): relative "
              f"{nums['rel_to_jax']:.2e} (limit {CFG3_OBJ_RTOL})",
              flush=True)
    for name, nums in out.items():
        check(nums["converged"], f"config 3 row {name} did not converge in "
              f"{nums['iterations']} iterations")
        check(nums["rel_to_jax"] <= CFG3_OBJ_RTOL,
              f"config 3 row {name}: objective {nums['objective']} vs the "
              f"JAX package's {nums['jax_cpu_f32_objective']}")
    chain = ["risk_neutral"] + [f"avar[{a}]" for a in CFG3_ALPHAS]
    for hi, lo in zip(chain, chain[1:]):
        check(out[lo]["objective"] >= out[hi]["objective"]
              * (1 - CFG3_OBJ_RTOL),
              f"config 3: {lo} below {hi}: risk ordering broken")
    check(out["evar[0.5]"]["objective"] >= out["avar[0.5]"]["objective"]
          * (1 - CFG3_OBJ_RTOL), "config 3: EVaR_0.5 below AV@R_0.5")
    print(f"[cfg3] every row converged, within {CFG3_OBJ_RTOL} of the JAX "
          f"package's objectives; AV@R does not decrease as alpha falls "
          f"(risk-neutral as alpha = 1) and EVaR_0.5 >= AV@R_0.5, with that "
          f"slack [{card}]", flush=True)
    return dict(rows=out, concurrent_s=conc_s, step_launches=total)


def cfg3_paths(card, opts):
    """8b: AV@R_0.5 at N = 12 on the three paths, CFG3_PATH_ITERS cold
    iterations each: the fused step (B = 1: one block), the sweep kernels
    (fused_step=False) and the composed path (fused_sweep=False, the prox_h*
    kernel).  ms per iteration from an unprofiled run, the device's busy
    share from a profiled one (its kernel time over the unprofiled wall
    time)."""
    from torch.profiler import ProfilerActivity, profile

    from spock_tpu_torch import build

    rows, x0 = cfg3_rows(CFG3_N)
    spec = dict(rows)["avar[0.5]"]
    data, meta = build(spec, dtype=torch.float32)
    out = {}
    for label, kw in (("fused step", {}),
                      ("sweep kernels", dict(fused_step=False)),
                      ("composed", dict(fused_sweep=False))):
        r = {}
        cfg3_solve(data, meta, x0, r, max_iter=CFG3_PATH_ITERS, **kw)  # warm
        if "error" in r:
            raise r["error"]
        reset_counts()
        r = {}
        cfg3_solve(data, meta, x0, r, max_iter=CFG3_PATH_ITERS, **kw)
        counts = {k: c for k, c in launch_counts().items() if c}
        iters = int(r["res"].iterations)
        wall_ms = 1e3 * r["wall_s"] / iters
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            rp = {}
            cfg3_solve(data, meta, x0, rp, max_iter=CFG3_PATH_ITERS, **kw)
            torch.cuda.synchronize()
        if "error" in rp:
            raise rp["error"]
        dev_us = sum(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
                     for e in prof.key_averages()
                     if str(getattr(e, "device_type", "")).endswith("CUDA"))
        dev_ms = dev_us / 1e3 / iters
        out[label] = dict(ms_per_iteration=wall_ms, iterations=iters,
                          device_ms_per_iteration=dev_ms or None,
                          device_busy_share=(dev_ms / wall_ms) if dev_ms
                          else None, launches=counts)
        busy = (f"{100 * dev_ms / wall_ms:.1f}%" if dev_ms
                else "not measured (the profiler saw no kernel)")
        print(f"[cfg3 paths] avar[0.5] N={CFG3_N} B=1, {label}: "
              f"{wall_ms:.2f} ms per iteration over {iters}, device "
              f"{dev_ms:.2f} ms per iteration, busy {busy}; launches "
              f"{counts} [{card}]", flush=True)
    return out, (spec, data, meta, x0)


def cfg3_step_rows(cfg, card, opts, tag=CFG3_TAG, tol=CFG3_TOL,
                   reps=CFG3_STEP_REPS, no_cache=False, data64=None):
    """8b, the step kernels at config 3's B = 1 (265,720 nodes, costates in
    device memory) on a real carry three fused iterations into the AV@R_0.5
    solve: #7 (tau = 1, the carry's cache flag, or none with ``no_cache``)
    and #6 (the backtrack, the lane made to loop), each held in float64
    against its plain version and timed in float32 (median of ``reps``)
    with its byte and operation bound; rows named ``name[tag]`` (9a runs it
    on config 4, with its float64 build ``data64``).  #7's float64 kernel
    outputs wait on the host while the plain version runs, and what is done
    with is freed, so that the card holds one float64 carry."""
    from spock_tpu_torch import build
    from spock_tpu_torch.algorithms import supermann as sp
    from spock_tpu_torch.ops import spstep, sweep_kernels
    from spock_tpu_torch.problem import step_size
    from spock_tpu_torch.solver import zero_dual, zero_primal
    from spock_tpu_torch.zv import leaves, tmap

    spec, data, meta, x0 = cfg
    xb = torch.tensor(x0[None], dtype=torch.float32, device=data.device)
    c = sp.sp_init_fused(meta, xb, zero_primal(meta, (1,), torch.float32),
                         zero_dual(meta, (1,), torch.float32), opts)
    bodies = [sp.sp_body_fused(data, meta, tol, opts, phase=ph)
              for ph in range(3)]
    for k in range(3):
        c = bodies[k](c)
    knobs = dict(c1=opts.c1, sigma_k2=opts.sigma_k2, lam=opts.lam,
                 lam_sp=opts.lam_sp)
    g = step_size(data)
    if data64 is None:
        data64, _ = build(spec, dtype=torch.float64)
    meta64 = meta
    g64 = step_size(data64)
    consts = sweep_kernels._consts(data, meta)[:sweep_kernels.N_CONSTS]
    ones = torch.ones_like(c.r_safe)
    cache = torch.zeros_like(c.cache_valid) if no_cache else c.cache_valid
    args = sp.step_inputs(c, opts, c.it % 3, ~c.done, cache, c.r_safe, ones)
    del c, bodies
    args64 = tmap(lambda a: a.double(), args)
    rows = []
    # #7: tau = 1
    name = row_name("sp_step_fused_tau1", tag)
    got64 = list(spstep.sp_step_fused(data64, meta64, *args64, g64, g64,
                                      **knobs))
    host7 = to_host(tuple(got64[:7]))
    for j in (1, 2, 4, 5):  # #6 reads z_new, s, the scalars and what it kept
        got64[j] = None
    ref64 = spstep.sp_step_ref(data64, meta64, *args64, g64, g64,
                               **knobs)[:7]
    err7, _ = hold_step(name, host7, ref64)
    del host7, ref64
    got = spstep.sp_step_fused(data, meta, *args, g, g, **knobs)
    nbytes, ops = step_bytes_ops(meta, args, got, consts)
    rows.append(kernel_row(
        name, STEP_SOURCE, STEP_ROWS["sp_step_fused_tau1"], err7,
        time_ms(lambda: spstep.sp_step_fused(data, meta, *args, g, g,
                                             **knobs),
                reps=reps, warmup=0),
        time_ms(lambda: spstep.sp_step_ref(data, meta, *args, g, g, **knobs),
                reps=reps, warmup=1, spin=4 * SPIN_CYCLES),
        nbytes, ops, card, batch=1))
    # #6: the backtrack of the lane, made to loop
    name = row_name("sp_step_backtrack", tag)
    bt = (opts.beta, opts.max_backtracks)

    def looping(oscal):
        o = oscal.clone()
        o[:, spstep.OC_LOOP] = 1.0
        return o

    o64 = looping(got64[6])
    zk, sk = tmap(torch.clone, got64[0]), tmap(torch.clone, got64[3])
    zr, sr = tmap(torch.clone, got64[0]), tmap(torch.clone, got64[3])
    out64 = spstep.sp_step_backtrack(data64, meta64, *args64[:2], got64[7],
                                     args64[9], args64[10], o64, zk, sk, g64,
                                     g64, *bt, **knobs)
    outr, _ = spstep.sp_backtrack_ref(data64, meta64, *args64[:2], got64[7],
                                      args64[9], args64[10], o64, zr, sr,
                                      g64, g64, *bt, **knobs)
    torch.cuda.synchronize()
    err6, _ = hold_step(name, (zk, sk, out64), (zr, sr, outr))
    check(torch.equal(out64[:, spstep.OC_TRIALS], outr[:, spstep.OC_TRIALS]),
          f"{name}: float64 trials differ from the plain version")
    del zk, sk, zr, sr, out64, outr, got64, args64
    torch.cuda.empty_cache()
    o32 = looping(got[6])
    zt, st = tmap(torch.clone, got[0]), tmap(torch.clone, got[3])
    trials = int(spstep.sp_step_backtrack(
        data, meta, *args[:2], got[7], args[9], args[10], o32, zt, st, g, g,
        *bt, **knobs)[0, spstep.OC_TRIALS])
    nbytes, ops = backtrack_bytes_ops(meta, 1, trials,
                                      nbytes_of(leaves(args[:2])), consts,
                                      lanes=1)
    rows.append(kernel_row(
        name, STEP_SOURCE, STEP_ROWS["sp_step_fused"], err6,
        time_ms(lambda: spstep.sp_step_backtrack(
            data, meta, *args[:2], got[7], args[9], args[10], o32, zt, st,
            g, g, *bt, **knobs), reps=reps, warmup=0),
        time_ms(lambda: spstep.sp_backtrack_ref(
            data, meta, *args[:2], got[7], args[9], args[10], o32, zt, st,
            g, g, *bt, **knobs), reps=reps, warmup=1,
            spin=4 * SPIN_CYCLES),
        nbytes, ops, card, batch=1))
    plan = spstep.smem_plan(data, meta, torch.float32)
    print(f"[{tag} step] the backtrack made {trials} trials; step kernels' "
          f"plan at B=1, N={meta.tree.N}: {plan} [{card}]", flush=True)
    return rows, dict(backtrack_trials=trials, smem_plan=plan)


def cfg3_small_solves():
    """8c's float32 solves of the seven rows at N = 4 (40 nodes), cold, on
    each row's default path, at config 3's tol 1e-4 and at
    CFG3_SMALL_SOLVE_TOL, in a worker process of its own (host-bound at
    this size, they then overlap 8a).  Returns {row: {tol: (iterations,
    converged, root controls, objective)}} and each row's path."""
    from spock_tpu_torch import SuperMannOpts, build

    rows, x0 = cfg3_rows(CFG3_SMALL_N)
    out, paths = {}, {}
    for name, spec in rows:
        data, meta = build(spec, dtype=torch.float32)
        paths[name] = cfg3_path(data, meta, SuperMannOpts())
        out[name] = {}
        for tol in (CFG3_TOL, CFG3_SMALL_SOLVE_TOL):
            r = {}
            cfg3_solve(data, meta, x0, r, tol=tol, max_iter=CFG3_SMALL_CAP)
            if "error" in r:
                raise r["error"]
            res = r["res"]
            out[name][tol] = (int(res.iterations), bool(res.converged),
                              res.z.u[:, 0].double().cpu().numpy(),
                              float(res.z.s[0]))
    return out, paths


def cfg3_small(card, solves, refs):
    """8c: the f32 solves of :func:`cfg3_small_solves` (``solves``, its
    submitted job) against float64 solves at tol 1e-9 (``refs``: row ->
    submitted solve): the native oracle's for the rows it takes, the port's
    on the host's CPU for EVaR.  At config 3's tol 1e-4 the errors are
    reported; at CFG3_SMALL_SOLVE_TOL the root controls must lie within
    CFG3_SMALL_TOL and the objective within CFG3_SMALL_TOL relative."""
    got, paths = solves.get()
    out = {}
    for name, by_tol in got.items():
        u_ref, obj_ref, ref_s, ref_iters = reference(refs[name], name)
        if name.startswith("evar"):
            what = "the port's f64 solve on the host's CPU"
        else:
            u_ref, obj_ref, what = u_ref[0], float(obj_ref[0]), ORACLE
        out[name] = dict(path=paths[name], reference=what,
                         reference_s=ref_s, reference_iterations=ref_iters,
                         reference_objective=obj_ref)
        for tol, (iters, conv, u, obj) in by_tol.items():
            check(conv, f"config 3 N={CFG3_SMALL_N} row {name} did not "
                  f"converge at tol {tol}")
            nums = dict(iterations=iters,
                        controls_max_err=float(np.abs(u - u_ref).max()),
                        objective_rel_err=abs(obj - obj_ref) / abs(obj_ref))
            out[name][f"tol {tol}"] = nums
            held = tol == CFG3_SMALL_SOLVE_TOL
            print(f"[cfg3 N={CFG3_SMALL_N}] {name}: f32 at tol {tol}, "
                  f"{iters} iterations on {paths[name]}; root controls "
                  f"{nums['controls_max_err']:.3e}, objective "
                  f"{nums['objective_rel_err']:.3e} relative from {what} "
                  f"(tol {CFG3_REF_TOL}, {ref_iters} iterations, "
                  f"{ref_s:.1f} s)"
                  + (f"; limit {CFG3_SMALL_TOL}" if held else
                     "; reported, not held") + f" [{card}]", flush=True)
            if held:
                check(nums["controls_max_err"] <= CFG3_SMALL_TOL
                      and nums["objective_rel_err"] <= CFG3_SMALL_TOL,
                      f"config 3 N={CFG3_SMALL_N} row {name}: {nums} from "
                      "the float64 reference")
    return out


def cfg3_evar_reference():
    """8c's float64 EVaR reference at N = 4: the port's plain solve at tol
    1e-9, on the host's CPU in a worker process (40 nodes: host-bound on
    either device, and ~5x faster here than on the card beside 8a).
    Returns (root controls, objective, seconds, iterations, converged)."""
    from spock_tpu_torch import build
    from spock_tpu_torch.solver import Solver

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    rows, x0 = cfg3_rows(CFG3_SMALL_N)
    data, meta = build(dict(rows)["evar[0.5]"], dtype=torch.float64,
                       device="cpu")
    res = Solver(data, meta, algorithm="spock", max_iter=REF_CAP,
                 device="cpu").solve(x0, tol=CFG3_REF_TOL)
    return (res.z.u[:, 0].numpy(), float(res.z.s[0]),
            time.perf_counter() - t0, int(res.iterations),
            bool(res.converged))


def submit_cfg3_refs(pool):
    """8c's float64 references (tol 1e-9) of the N = 4 rows, in the worker
    pool from the start of the run: the native oracle's, and for EVaR
    (whose exponential cone the oracle does not take) the port's."""
    from spock_tpu_torch.baselines.native import NativeSolver

    rows, x0 = cfg3_rows(CFG3_SMALL_N)
    out = {}
    for name, spec in rows:
        if spec.risk.kind == "evar":
            out[name] = pool.apply_async(cfg3_evar_reference)
            continue
        NativeSolver(spec)  # raises here for a problem it does not take
        out[name] = pool.apply_async(
            oracle_solve, (spec, x0[None], CFG3_REF_TOL, CFG3_REF_CAP))
    return out


def record_checks(data, meta, x0, card, opts):
    """8d: record mode on the card, on the headline problem at B lanes: a
    cold fused-step ``run_supermann(record=True)`` and a cold
    ``run_cp(record=True)``; per lane, the last recorded row is the
    reported (xi1, xi2), the trace is positive up to it, and the
    backtracking column holds whole numbers <= max_backtracks.  Then one
    recorded fused iteration captured in a CUDA graph and replayed: its
    trace row equals the eager call's (no host sync in a recorded
    iteration)."""
    from spock_tpu_torch.algorithms import cp, supermann as sp
    from spock_tpu_torch.solver import zero_dual, zero_primal
    from spock_tpu_torch.zv import tmap

    def start():
        return (zero_primal(meta, (B,), data.dtype),
                zero_dual(meta, (B,), data.dtype))

    out = {}
    check(sp.use_fused_step(data, meta, opts), "the headline's fused step")
    for label, run in (
            ("run_supermann", lambda: sp.run_supermann(
                data, meta, x0, *start(), tol=TOL, max_iter=COLD_CAP,
                opts=opts, record=True)),
            ("run_cp", lambda: cp.run_cp(data, meta, x0, *start(), tol=TOL,
                                         max_iter=CP_CAP, record=True))):
        reset_counts()
        res = run()
        counts = {k: c for k, c in launch_counts().items() if c}
        tr = res.residuals.cpu().numpy()
        it = res.iterations.cpu().numpy()
        last = tr[it - 1, np.arange(B)]
        fin = torch.stack([res.xi1, res.xi2], -1).cpu().numpy()
        check(np.array_equal(last[:, :2], fin),
              f"recorded {label}: the last row is not the final residual")
        check(all(bool(np.all(tr[:n, b, :2] > 0)) for b, n in enumerate(it)),
              f"recorded {label}: a residual <= 0 in the trace")
        nums = dict(shape=list(tr.shape), iterations_max=int(it.max()),
                    converged=int(res.converged.sum()), launches=counts)
        if label == "run_supermann":
            rounds = tr[: int(it.max()), :, 2]
            check(bool(np.all(rounds == np.round(rounds)))
                  and bool(np.all((rounds >= 0)
                                  & (rounds <= opts.max_backtracks))),
                  "recorded run_supermann: backtracking rounds out of range")
            check(tr.shape[0] == COLD_CAP + 2, "the fused trace's rows")
            nums["rounds_total"] = int(rounds[:, 0].sum())
        out[label] = nums
        print(f"[record] {label} B={B} cold: trace {tr.shape}, "
              f"{nums['converged']} lanes converged, iterations up to "
              f"{int(it.max())}, last rows equal the final (xi1, xi2); "
              f"launches {counts} [{card}]", flush=True)
    # one recorded fused iteration in a CUDA graph
    c = sp.sp_init_fused(meta, x0, *start(), opts, max_iter=10, record=True)
    bodies = [sp.sp_body_fused(data, meta, TOL, opts, phase=ph, record=True)
              for ph in range(3)]
    for k in range(3):  # builds the constants and the retrial counter
        c = bodies[k](c)
    body = bodies[c.it % 3]
    def clone(carry):
        return tmap(lambda a: a.clone() if torch.is_tensor(a) else a, carry)

    eager = body(clone(c))
    static = clone(c)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body(clone(c))  # warm-up on the capture's stream
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):  # a capture runs nothing
        captured = body(static)
    graph.replay()
    torch.cuda.synchronize()
    row = c.it
    check(torch.equal(captured.hist[row], eager.hist[row])
          and torch.equal(captured.z.u, eager.z.u),
          "the graphed recorded iteration differs from the eager one")
    out["graph_row"] = captured.hist[row].cpu().tolist()[:2]
    print(f"[record] one recorded fused iteration (row {row}) captured in a "
          f"CUDA graph and replayed: its trace row and z equal the eager "
          f"call's [{card}]", flush=True)
    return out


def cfg4_spec():
    """BASELINE config 4 as examples/bigtree_scaling.py builds it: the
    port's server_heat N=15 nx=4 d=3 with the band -2 <= 1'x <= 2 at every
    non-leaf and leaf node."""
    import dataclasses

    from spock_tpu_torch import problem
    from spock_tpu_torch.models import server_heat

    spec = server_heat.make_spec(N=CFG4_N, nx=CFG4_NX, d=CFG4_D)
    ones = np.ones((1, CFG4_NX))
    lo, hi = np.array([-CFG4_BAND]), np.array([CFG4_BAND])
    return dataclasses.replace(spec, polytope=problem.Polytope(
        Gx=ones, Gu=np.zeros((1, CFG4_NX)), lo=lo, hi=hi, GxN=ones, loN=lo,
        hiN=hi))


def cfg4_build(card):
    """9a: config 4 built in float32 on the card (the offline phase: the
    Riccati factors and projectors in float64 numpy, ||L||^2 by power
    iteration on the card), timed."""
    from spock_tpu_torch import build

    spec = cfg4_spec()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data, meta = build(spec, dtype=torch.float32)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t = meta.tree
    check(t.n == CFG4_NODES, f"config 4 has {t.n} nodes, not {CFG4_NODES}")
    nums = dict(build_s=build_s, L_sq=float(data.L_sq), nodes=t.n,
                nonleaf=t.n_nonleaf, leaves=t.n_leaf,
                pair_bytes=4 * (meta.nz + meta.nv))
    print(f"[cfg4] build: server_heat N={CFG4_N} nx={CFG4_NX} d={CFG4_D} "
          f"with the band, {t.n} nodes ({t.n_nonleaf} non-leaf, {t.n_leaf} "
          f"leaves), a lane's (z, v) {nums['pair_bytes']} bytes in float32; "
          f"build {build_s:.3f} s, ||L||^2 {nums['L_sq']:.6f} [{card}]",
          flush=True)
    return spec, data, meta, nums


def cfg4_sweep_rows(data, data64, meta, card):
    """9a: #2, #3 and #4 on config 4 at B = 1, one launch each on random
    inputs drawn on the card: in float64 against the plain version (within
    1e-9 (1 + scale); the dot products' scale is sum |a_i b_i|; the kernel's
    outputs wait on the host while the plain version runs) and timed in
    float32 on the same inputs rounded (median of CFG4_REPS, a spin kernel
    ahead)."""
    from spock_tpu_torch.algorithms import common
    from spock_tpu_torch.ops import linop, sweep_kernels
    from spock_tpu_torch.problem import step_size
    from spock_tpu_torch.zv import leaves, sub, tmap

    meta64 = meta

    def inputs(dt):
        gen = torch.Generator(device=data.device)
        gen.manual_seed(1)

        def pair():
            return sweep_kernels.new_pair(meta, 1, lambda s: torch.randn(
                s, generator=gen, dtype=torch.float64,
                device=data.device).to(dt))

        (z, v), (dz, dv) = pair(), pair()
        x0 = torch.tensor([CFG4_X0], dtype=dt, device=data.device)
        tau = torch.tensor([0.6], dtype=dt, device=data.device)
        return z, v, dz, dv, x0, tau

    def calls(d_, m_, z, v, dz, dv, x0, tau):
        g = step_size(d_)
        return {
            "cp_sweep_fused": (
                lambda: sweep_kernels.cp_sweep_fused(d_, m_, z, v, g, g, x0),
                lambda: common.cp_sweep_ref(d_, m_, z, v, g, g, x0)),
            "cp_sweep_metric_fused": (
                lambda: sweep_kernels.cp_sweep_metric_fused(d_, m_, z, v, g,
                                                            g, x0),
                lambda: common.cp_sweep_metric_ref(d_, m_, z, v, g, g, x0)),
            "candidate_sweep_fused": (
                lambda: sweep_kernels.candidate_sweep_fused(
                    d_, m_, z, v, dz, dv, tau, g, g, x0),
                lambda: common.candidate_sweep_ref(d_, m_, z, v, dz, dv, tau,
                                                   g, g, x0)),
        }

    body = sweep_kernels.sweep_body(meta, data, torch.float32)
    check(body == "node", f"config 4 takes the {body} body of the sweeps")
    consts = sweep_kernels._consts(data, meta)[:sweep_kernels.N_CONSTS]
    rows = []
    for name in ("candidate_sweep_fused", "cp_sweep_metric_fused",
                 "cp_sweep_fused"):
        # float64: kernel and plain version, compared on the host
        z, v, dz, dv, x0, tau = inputs(torch.float64)
        kernel, plain = calls(data64, meta64, z, v, dz, dv, x0, tau)[name]
        got = to_host(kernel())
        ref = plain()
        scales = {}
        if name != "cp_sweep_fused":
            g = step_size(data64)
            dot = 2 * len(leaves(ref[:2]))
            base = (z, v)
            if name == "candidate_sweep_fused":
                base = tmap(lambda a, b: a + tau.reshape(
                    (1,) + (1,) * (a.ndim - 1)) * b, (z, v), (dz, dv))
            r = sub(base, (ref[0], ref[1]))
            scales[dot] = float(sum(
                (a.abs() * b.abs()).sum() for a, b in zip(
                    leaves(r), leaves(ref[2:4]))))
            if name == "candidate_sweep_fused":
                md = linop.metric_apply(data64, meta64, dz, dv, g, g)
                scales[dot + 3] = float(sum(
                    (a.abs() * b.abs()).sum() for a, b in zip(
                        leaves(r), leaves(md))))
                del md
            del r, base
        del z, v, dz, dv
        err = hold(row_name(name, CFG4_TAG), got, ref, scales,
                   rtol=STEP_RTOL64)
        del got, ref
        torch.cuda.empty_cache()
        # float32: timed
        ins = inputs(torch.float32)
        kernel, plain = calls(data, meta, *ins)[name]
        out = kernel()
        torch.cuda.synchronize()
        nbytes = nbytes_of(leaves(tuple(
            ins[:2] + ((ins[2], ins[3], ins[5]) if name ==
                       "candidate_sweep_fused" else ()) + (ins[4],)))
            + leaves(out) + consts)
        del out
        ops = sweep_ops(meta, name != "cp_sweep_fused",
                        name == "candidate_sweep_fused")
        source, replaces = SWEEP_KERNELS[name]
        rows.append(kernel_row(
            row_name(name, CFG4_TAG), source, replaces, err,
            time_ms(kernel, reps=CFG4_REPS, warmup=0),
            time_ms(plain, reps=CFG4_REPS, warmup=1, spin=4 * SPIN_CYCLES),
            nbytes, ops, card, batch=1))
        del ins, kernel, plain
        torch.cuda.empty_cache()
    return rows


def cfg4_rows(spec, data, meta, card, opts):
    """9a: kernels #7, #6 (the step rows of 8b, #7 with no cache), #4, #3
    and #2 held in float64 and timed in float32 on config 4 at B = 1."""
    from spock_tpu_torch import build

    data64, _ = build(spec, dtype=torch.float64)
    rows, step = cfg3_step_rows(
        (spec, data, meta, np.array(CFG4_X0)), card, opts, tag=CFG4_TAG,
        tol=CFG4_TOL, reps=CFG4_REPS, no_cache=True, data64=data64)
    stamp("9a step rows done")
    rows += cfg4_sweep_rows(data, data64, meta, card)
    del data64
    torch.cuda.empty_cache()
    return rows, step


def carry_err(a, b) -> float:
    """max |a - b| over the floating-point tensors of two SuperMann
    carries (equal values, infinities too, differ by 0)."""
    import dataclasses

    from spock_tpu_torch.zv import leaves

    worst = 0.0
    for f in dataclasses.fields(a):
        for x, y in zip(leaves(getattr(a, f.name)),
                        leaves(getattr(b, f.name))):
            if torch.is_tensor(x) and x.is_floating_point():
                worst = max(worst, abs_err(x, y))
    return worst


def cfg4_solve(data, meta, card, opts):
    """9b: the cold converged config 4 solve through
    ``bigtree.run_sp_sharded`` on ``mesh.make_mesh()`` (one rank, NCCL;
    the partition stage k = 0, the share the whole tree), f32, tol 1e-3 in
    at most 1000 iterations, with the launch counts set to 0 just before
    and read just after (the composed path: none).  Then its ms per
    iteration, the device's busy share over CFG4_PROFILE_ITERS profiled
    iterations, its peak memory and collectives; the band at every node;
    one iteration from the same carry against the unsharded composed
    ``sp_body``, and CFG4_CP_ITERS ``run_cp_sharded`` iterations against
    ``Solver(algorithm="cp", fused_sweep=False)``, both bitwise at k = 0;
    and the same two holds with the tree split at the stage
    CFG4_STAGE_RANKS ranks would split (one rank holding every column, so
    that every boundary exchange runs on the card), within CFG4_STAGE_RTOL,
    with their collectives counted."""
    import dataclasses

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from spock_tpu_torch.algorithms import supermann as sp
    from spock_tpu_torch.parallel import bigtree, mesh as pmesh
    from spock_tpu_torch.solver import Solver, zero_dual, zero_primal
    from spock_tpu_torch.zv import leaves

    mesh = pmesh.make_mesh()
    backend = dist.get_backend(mesh.group)
    check(mesh.size == 1 and backend == "nccl",
          f"the one-card mesh is {backend} over {mesh.size} ranks")
    x0 = torch.tensor([CFG4_X0], dtype=torch.float32, device=mesh.device)

    def solve(max_iter, stats=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, _ = bigtree.run_sp_sharded(data, meta, x0, CFG4_TOL, max_iter,
                                        mesh, opts=opts, stats=stats)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counts()
    stats = {}
    res, wall_s = solve(CFG4_CAP, stats)
    launches = {k: c for k, c in launch_counts().items() if c}
    peak = torch.cuda.max_memory_allocated()
    iters, status = int(res.iterations[0]), int(res.status[0])
    band = res.z.x[0].sum(0)  # 1'x at every node
    lo, hi = float(band.min()), float(band.max())
    objective = float(res.z.s[0, 0])
    nums = dict(iterations=iters, status=status, wall_s=wall_s,
                ms_per_iteration=1e3 * wall_s / max(iters, 1),
                objective=objective, band=(lo, hi), peak_bytes=peak,
                held_bytes=held,
                xi=(float(res.xi1[0]), float(res.xi2[0])), stats=stats,
                launches=launches)
    print(f"[cfg4 solve] run_sp_sharded on a one-rank {backend} mesh "
          f"(stage {stats['stage']}): status {status}, {iters} iterations, "
          f"{wall_s:.2f} s, {nums['ms_per_iteration']:.2f} ms per iteration,"
          f" objective {objective:.6f}, xi {nums['xi']}, 1'x in "
          f"[{lo:.6f}, {hi:.6f}], peak device memory {peak / 1e9:.2f} GB "
          f"({held / 1e9:.2f} GB of it held before the solve began: the "
          f"solve's own {(peak - held) / 1e9:.2f} GB), "
          f"launches {launches}; collectives per iteration "
          f"{stats['count']:.2f} ({stats['by_kind']}), "
          f"{stats['bytes']:.1f} bytes against a "
          f"{stats['iterate_bytes']} byte iterate [{card}]", flush=True)
    del res
    check(status == 0, f"config 4 did not reach tol {CFG4_TOL} in "
          f"{CFG4_CAP} iterations (xi {nums['xi']})")
    check(not launches, f"the composed config 4 solve launched {launches}")
    check(math.isfinite(objective), "config 4's objective is not finite")
    check(lo >= -CFG4_BAND - CFG4_BAND_TOL and hi <= CFG4_BAND + CFG4_BAND_TOL,
          f"config 4's band 1'x in [{lo}, {hi}] leaves [-2, 2] by more than "
          f"{CFG4_BAND_TOL}")
    # the device's busy share over a few profiled iterations from cold
    _, short_s = solve(CFG4_PROFILE_ITERS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solve(CFG4_PROFILE_ITERS)
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
                 for e in prof.key_averages()
                 if str(getattr(e, "device_type", "")).endswith("CUDA"))
    nums["device_ms_per_iteration"] = dev_us / 1e3 / CFG4_PROFILE_ITERS
    nums["busy_share"] = (dev_us / 1e6 / short_s) if dev_us else None
    print(f"[cfg4 solve] {CFG4_PROFILE_ITERS} iterations from cold: "
          f"{1e3 * short_s / CFG4_PROFILE_ITERS:.2f} ms each, the device "
          f"{nums['device_ms_per_iteration']:.2f} ms, busy "
          + (f"{100 * nums['busy_share']:.1f}%" if dev_us else
             "not measured (the profiler saw no kernel)")
          + f" [{card}]", flush=True)
    # one iteration from the same carry, two iterations in: at stage 0 (the
    # share the whole tree) and at a split stage, where every boundary
    # exchange runs (one rank holds every column)
    sh = bigtree.Sharded(data, meta, mesh)
    c = sp.sp_init(meta, x0, zero_primal(meta, (1,), torch.float32),
                   zero_dual(meta, (1,), torch.float32), opts)
    plain = sp.sp_body(data, meta, CFG4_TOL, opts, fused_sweep=False)
    for _ in range(2):
        c = plain(c)
    ref = plain(c)
    check(sh.part.k == 0, f"one rank splits stage {sh.part.k}")
    got = sp.sp_body(sh.data, sh.meta, CFG4_TOL, opts, fused_sweep=False,
                     ops=sh.ops)(c)
    nums["one_iteration_err"] = carry_err(got, ref)
    del got
    stage = bigtree.partition_stage(meta.tree, CFG4_STAGE_RANKS)
    shk = bigtree.Sharded(data, meta, mesh, stage)
    node = ("z", "v", "r_prev", "s_prev", "dirstate", "zbar_c", "vbar_c")
    local = dataclasses.replace(c, **{f: shk.share(getattr(c, f))
                                      for f in node})
    del c
    shk.comm.reset()
    got = sp.sp_body(shk.data, shk.meta, CFG4_TOL, opts, fused_sweep=False,
                     ops=shk.ops)(local)
    torch.cuda.synchronize()
    sp_comm = {kind: dict(count=n, bytes=nb)
               for kind, (n, nb) in shk.comm.counts.items()}
    del local
    err, scale = 0.0, 0.0
    for f in dataclasses.fields(ref):
        mine = getattr(got, f.name)
        if f.name in node:
            mine = shk.whole(mine)
        for x, y in zip(leaves(mine), leaves(getattr(ref, f.name))):
            if torch.is_tensor(y) and y.is_floating_point():
                err = max(err, abs_err(x, y))
                fin = y[torch.isfinite(y)]
                if fin.numel():
                    scale = max(scale, float(fin.abs().max()))
        del mine
    nums["stage_hold"] = dict(stage=stage, sp_err=err, sp_scale=scale,
                              sp_collectives=sp_comm)
    del got, ref
    torch.cuda.empty_cache()
    # CFG4_CP_ITERS iterations of node-sharded CP and of the Solver's; and
    # CFG4_STAGE_CP_ITERS of node-sharded CP split at the stage above
    res_s, _ = bigtree.run_cp_sharded(data, meta, x0, CFG4_TOL,
                                      CFG4_CP_ITERS, mesh)
    res_u = Solver(data, meta, algorithm="cp", fused_sweep=False,
                   max_iter=CFG4_CP_ITERS).solve(x0, tol=CFG4_TOL)
    nums["cp_err"] = max(abs_err(a, b) for a, b in zip(
        leaves((res_s.z, res_s.v)), leaves((res_u.z, res_u.v))))
    check(torch.equal(res_s.iterations, res_u.iterations),
          "node-sharded CP ran other iterations than the Solver's")
    del res_s, res_u
    cp_stats = {}
    res_k, _ = bigtree.run_cp_sharded(data, meta, x0, CFG4_TOL,
                                      CFG4_STAGE_CP_ITERS, mesh,
                                      stats=cp_stats, stage=stage)
    res_u = Solver(data, meta, algorithm="cp", fused_sweep=False,
                   max_iter=CFG4_STAGE_CP_ITERS).solve(x0, tol=CFG4_TOL)
    pairs = list(zip(leaves((res_k.z, res_k.v)), leaves((res_u.z, res_u.v))))
    hold_k = nums["stage_hold"]
    hold_k.update(
        cp_err=max(abs_err(a, b) for a, b in pairs),
        cp_scale=max(float(b.abs().max()) for _, b in pairs),
        cp_iterations=int(res_k.iterations[0]),
        cp_collectives=cp_stats["by_kind"])
    check(torch.equal(res_k.iterations, res_u.iterations),
          f"node-sharded CP at stage {stage} ran other iterations than the "
          "Solver's")
    del res_k, res_u, pairs
    torch.cuda.empty_cache()
    print(f"[cfg4 solve] one SuperMann iteration from the same carry against "
          f"the unsharded composed sp_body: max |diff| "
          f"{nums['one_iteration_err']:.3e}; {CFG4_CP_ITERS} CP iterations "
          f"against Solver(algorithm='cp', fused_sweep=False): max |diff| "
          f"{nums['cp_err']:.3e} (held at 0: at stage 0 the share is the "
          f"whole tree) [{card}]", flush=True)
    print(f"[cfg4 stage] split at stage {stage} ({meta.tree.d ** stage} "
          f"columns, every one on this rank): one SuperMann iteration from "
          f"the same carry, max |diff| {hold_k['sp_err']:.3e} (scale "
          f"{hold_k['sp_scale']:.3e}), collectives {sp_comm}; "
          f"{CFG4_STAGE_CP_ITERS} CP iterations, max |diff| "
          f"{hold_k['cp_err']:.3e} (scale {hold_k['cp_scale']:.3e}), "
          f"collectives per iteration {cp_stats['by_kind']}; held within "
          f"{CFG4_STAGE_RTOL} (1 + scale) [{card}]", flush=True)
    check(nums["one_iteration_err"] == 0.0 and nums["cp_err"] == 0.0,
          "node-sharded iterations differ from the unsharded ones")
    for what in ("sp", "cp"):
        check(hold_k[f"{what}_err"]
              <= CFG4_STAGE_RTOL * (1 + hold_k[f"{what}_scale"]),
              f"node-sharded {what} at stage {stage} differs from the "
              f"unsharded by {hold_k[f'{what}_err']}")
    check(sp_comm.get("all_gather", {}).get("count", 0) > 0
          and cp_stats["by_kind"].get("all_gather", {}).get("count", 0) > 0,
          f"no boundary exchange ran at stage {stage}")
    return nums


def lane_farm(data, meta, x0, ws, card):
    """9c: the headline farm lane-sharded on the one-rank NCCL mesh
    (``mesh.shard_batch``, ``replicate``, ``gather_batch``) on the main
    path (the fused step in graphed chunks), a cold window of COLD_STEPS,
    with the launch counts set to 0 just before and read just after;
    its gathered lanes bitwise equal to the unsharded farm's."""
    from spock_tpu_torch import mpc
    from spock_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.make_mesh()
    per = x0.shape[0] // mesh.size
    lanes = slice(mesh.rank * per, (mesh.rank + 1) * per)
    path = dict(n_steps=COLD_STEPS, max_total_iters=COLD_CAP,
                iters_per_launch=ITERS_PER_LAUNCH)
    reset_counts()
    res = mpc.simulate_async(pmesh.replicate(data, mesh), meta,
                             pmesh.shard_batch(x0, mesh), ws[:, lanes], TOL,
                             **path)
    counts = launch_counts()
    got = pmesh.gather_batch(dict(
        us=res.us.transpose(0, 1), xs=res.xs,
        iters_per_step=res.iters_per_step.transpose(0, 1),
        steps_done=res.steps_done), mesh)
    ref = mpc.simulate_async(data, meta, x0, ws, TOL, **path)
    want = dict(us=ref.us.transpose(0, 1), xs=ref.xs,
                iters_per_step=ref.iters_per_step.transpose(0, 1),
                steps_done=ref.steps_done)
    for k in want:
        check(torch.equal(got[k], want[k]),
              f"the lane-sharded farm's {k} differ from the unsharded "
              f"farm's by {abs_err(got[k].double(), want[k].double())}")
    check_step_farm(counts, res.run["executed"], "lane-sharded farm")
    counts = {k: c for k, c in counts.items() if c}
    print(f"[lanes] the headline farm over a one-rank NCCL mesh "
          f"(shard_batch, replicate, gather_batch), {COLD_STEPS} cold steps "
          f"in {res.total_iterations} farm iterations on the fused step in "
          f"graphed chunks of {ITERS_PER_LAUNCH} ({res.run['executed']} run):"
          f" launches {counts}; its "
          f"{x0.shape[0]} lanes equal the unsharded farm's bitwise (us, xs, "
          f"iters_per_step, steps_done) [{card}]", flush=True)
    return dict(launches=counts, farm_iterations=res.total_iterations,
                farm_iterations_run=res.run["executed"])


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; nothing was run")
    import spock_tpu_torch
    from spock_tpu_torch.baselines import native
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

    # ---- 2. build: every source at once, in the background, and the
    # native oracle's library (g++) beside them
    _build.start()
    oracle_error = []

    def build_oracle():
        try:
            native._lib()
        except Exception as exc:  # raised by built()
            oracle_error.append(exc)

    oracle_build = threading.Thread(target=build_oracle, daemon=True)
    oracle_build.start()

    @functools.cache
    def built():
        """Waits for every build (a failed one raises) and reports it:
        (seconds to the last library, ptxas summaries)."""
        _build.build_all()
        build_s = time.perf_counter() - T0
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
        oracle_build.join()
        if oracle_error:
            raise oracle_error[0]
        print(f"[oracle] g++ build of native/spock_cpu.cpp into "
              f"{native.library_path().name}: "
              + ("already built" if native.BUILD_SECONDS is None
                 else f"{native.BUILD_SECONDS:.1f} s"), flush=True)
        return build_s, ptxas

    # the native oracle's solves run in these workers, stopped on the way
    # out whatever happens
    try:
        with multiprocessing.get_context("spawn").Pool(REF_WORKERS) as pool:
            result = smoke(card, device, pool, built)
    finally:
        _build.wait()
        if torch.distributed.is_initialized():  # phase 9's one-rank mesh
            torch.distributed.destroy_process_group()
    run_s = time.perf_counter() - T0
    print(f"[time] the whole run took {run_s:.1f} s, {result['build_s']:.1f} "
          f"s of them until every kernel was built [{card}]", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": result["kernels"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def smoke(card, device, pool, built):
    """Phases 3-7; ``built()`` waits for every build and reports it.
    Returns the numbers written to build/chip_smoke.json."""
    from spock_tpu_torch import SuperMannOpts, build
    from spock_tpu_torch.models import server_heat
    from spock_tpu_torch.ops import spstep, sweep_kernels

    spec = server_heat.make_spec(N=N, nx=NX, d=D)
    data, meta = build(spec, dtype=torch.float32)
    check(data.device.type == "cuda", "build() did not default to the card")
    # phase 8c's native-oracle solves: fixed states, so from the start
    cfg3_refs = submit_cfg3_refs(pool)

    # ---- 3. the prox_h* kernel against its plain version ----
    kernels = [prox_kernel_check(data, meta, card)]
    rows = {k["name"]: k for k in kernels}

    rng = np.random.default_rng(0)
    x0 = torch.tensor(rng.uniform(-0.6, 0.6, (B, meta.nx)),
                      dtype=torch.float32, device=device)
    ws = torch.tensor(rng.integers(0, D, size=(COLD_STEPS + WARM_STEPS, B)),
                      device=device)

    # ---- 4c. the composed path (fused_sweep=False): the prox_h* kernel
    # alone, while the other kernels build ----
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
    stamp("4c done")

    # ---- 7d, 7b: the wider class's farms first, whose reference solves
    # then run beside the phases below ----
    opts = SuperMannOpts()
    wide_state = wide_farms(spec, x0, ws, card, device, opts, pool, built)
    build_s, ptxas = built()
    stamp("7d, 7b done")
    plans = {str(dt): spstep.smem_plan(data, meta, dt)
             for dt in (torch.float32, torch.float64)}
    for dt, plan in plans.items():
        print(f"[ptxas] step kernels, {dt}: {plan['bytes']} bytes of "
              f"dynamic shared memory per block, costates in shared memory "
              f"{plan['costates_in_shared_memory']}, "
              f"{plan['riccati_groups']} Riccati node groups", flush=True)
    for label, (d_, m_) in (("headline", (data, meta)),
                            (PNCOST, (wide_state.data_p, wide_state.meta_p))):
        for dt in (torch.float32, torch.float64):
            plan = sweep_kernels.node_plan(m_, d_, torch.finfo(dt).bits // 8)
            plans[f"cp_sweep node body, {label}, {dt}"] = plan
            mplan = sweep_kernels.metric_plan(m_, d_,
                                              torch.finfo(dt).bits // 8)
            plans[f"metric_apply node body, {label}, {dt}"] = mplan
            print(f"[ptxas] metric_apply node body, {label}, {dt}: "
                  f"{mplan['bytes']} bytes of dynamic shared memory per "
                  "block", flush=True)
            print(f"[ptxas] cp_sweep node body, {label}, {dt}: "
                  f"{plan['bytes']} bytes of dynamic shared memory per "
                  f"block, costates in shared memory "
                  f"{plan['costates_in_shared_memory']}, "
                  f"{plan['riccati_groups']} Riccati node groups", flush=True)

    # ---- 3. the sweep kernels against their plain versions: the node
    # body on the headline, the element body above 32 states ----
    sweep_rows = sweep_kernel_checks(data, meta, card)
    metric_extra = {}
    for batch, tag in ((B, None), (SOLVE_LANES, f"B{SOLVE_LANES}")):
        mrow, metric_extra[f"B{batch}"] = metric_kernel_check(
            data, meta, card, batch=batch, tag=tag)
        sweep_rows.append(mrow)
    kernels += sweep_rows
    rows.update({k["name"]: k for k in sweep_rows})
    element_rows, element = element_body_check(card, device)
    stamp("phase 3 sweep rows done")

    # ---- 4a. the main path: the farm on the fused step in graphed chunks
    # of ITERS_PER_LAUNCH iterations; then the same farm eagerly, held
    # bitwise ----
    res1, res2, nums, farm_iters = farm(data, meta, x0, ws, card, device,
                                        "fused-step", WARM_STEPS,
                                        iters_per_launch=ITERS_PER_LAUNCH)
    check_step_farm(nums["launches"], farm_iters, "fused-step")
    check(nums["cold_run"]["graphed"] and nums["warm_run"]["chunks"] >= 1
          and nums["cold_run"]["captures"] >= 1
          and nums["warm_run"]["captures"] == 0,
          f"the main path did not run in graph replays: {nums['cold_run']}, "
          f"{nums['warm_run']}")
    ref = submit_oracle(pool, spec, res2.xs)
    e1, e2, enums, e_iters = farm(data, meta, x0, ws, card, device,
                                  "fused-step eager", WARM_STEPS)
    check_step_farm(enums["launches"], e_iters, "fused-step eager")
    for phase, got, want in (("cold", res1, e1), ("warm", res2, e2)):
        check_bitwise(f"graphed {phase} farm", got, want)
    print(f"[graph] the graphed farm equals the eager farm bitwise, cold "
          f"and warm (us, xs, z, v, iters_per_step, steps_done, "
          f"total_iterations); ms per farm iteration: graphed "
          f"{nums['ms_per_farm_iteration']:.3f}, eager "
          f"{enums['ms_per_farm_iteration']:.3f} (before: "
          f"{BEFORE_GRAPHS[0]}); solves/s {nums['solves_per_s']:.2f}, eager "
          f"{enums['solves_per_s']:.2f} (before: {BEFORE_GRAPHS[3]}) "
          f"[{card}]", flush=True)
    nums["eager"] = enums

    # ---- 3, step rows: the step kernel on a real carry ----
    step_rows, step_extra = step_kernel_checks(
        data, meta, spec, res2, card, opts,
        mean_lanes=nums["looping_lanes_per_farm_iteration"])
    step_launches(step_rows, nums["launches"])
    kernels += step_rows
    stamp("4a and the step rows done")

    # ---- 4b. the fused sweep (fused_step=False): kernels #3 and #4 on the
    # node body ----
    _, _, snums, s_iters = farm(data, meta, x0, ws, card, device,
                                "fused-sweep", WARM_STEPS, fused_step=False)
    scounts = snums["launches"]
    check(scounts["cp_sweep_metric_fused"] >= 1,
          "the fused-sweep farm never launched cp_sweep_metric_fused")
    check(scounts["candidate_sweep_fused"] >= s_iters,
          f"candidate_sweep_fused launched {scounts['candidate_sweep_fused']} "
          f"times in {s_iters} farm iterations")
    check(scounts["sp_step_fused"] == 0 and scounts["sp_step_backtrack"] == 0,
          "the fused-sweep farm launched a step kernel")
    check_node_body(scounts, "fused-sweep farm", SWEEP_LAUNCHES)
    for name in ("cp_sweep_metric_fused", "candidate_sweep_fused"):
        rows[name]["launches"] = scounts[name]
    print(f"[paths] ms per farm iteration: fused step (graphed) "
          f"{nums['ms_per_farm_iteration']:.2f}, fused sweep "
          f"{snums['ms_per_farm_iteration']:.2f}, composed "
          f"{cnums['ms_per_farm_iteration']:.2f}; solves/s: "
          f"{nums['solves_per_s']:.2f}, {snums['solves_per_s']:.2f}, "
          f"{cnums['solves_per_s']:.2f} [{card}]", flush=True)

    # ---- 4d/4e. the Solver's paths: cp_sweep_fused, metric_apply_fused ----
    cp, u_cp = solver_run(data, meta, res2, card, "cp solve",
                          "cp_sweep_fused", algorithm="cp", max_iter=CP_CAP)
    check_node_body(cp["launches"], "cp solve", SWEEP_LAUNCHES)
    rows["cp_sweep_fused"]["launches"] = cp["launches"]["cp_sweep_fused"]
    broyden, u_broyden = solver_run(
        data, meta, res2, card, "broyden solve", "metric_apply_fused",
        max_iter=BROYDEN_CAP, supermann=SuperMannOpts(direction="broyden"))
    check_metric_body(broyden["launches"], "broyden solve", "node")
    for name in ("metric_apply_fused", f"metric_apply_fused[B{SOLVE_LANES}]"):
        rows[name]["launches"] = broyden["launches"]["metric_apply_fused"]

    # ---- 5. the solution ----
    sol, u_ref = solution_check(data, meta, spec, res2.xs, ws, card, device,
                                ref, ORACLE,
                                iters_per_launch=ITERS_PER_LAUNCH)
    err = sol["controls_max_err"]
    solver_controls((("cp solve", u_cp, cp),
                     ("broyden solve", u_broyden, broyden)), u_ref, card)

    # ---- 6. where the time goes ----
    stamp("4b-5 done")
    prof = profile_farm(data, meta, res2, ws, card, dict(
        eager=enums["ms_per_farm_iteration_run"],
        graphed=nums["ms_per_farm_iteration_run"]))
    stamp("6 done")
    main_path_line(nums, prof, card)

    # ---- 7. the wider class: kernel rows, Solvers and solutions ----
    wide = wide_checks(wide_state, ws, card, device, opts)
    kernels += wide.pop("rows") + element_rows
    stamp("7a-7d done")

    # ---- 8a. BASELINE config 3, the risk-measure sweep at N = 12.  In
    # worker processes beside its step-kernel rows (host-bound work, which
    # a thread here would hold up): 7e's _pncost reference, 8a's EVaR row
    # and 8c's float32 solves ----
    ref_p = pool.apply_async(reference_solve, (
        wide_state.spec_p, check_states(wide_state.res2_p.xs)))
    evar_job = pool.apply_async(cfg3_evar_row)
    small_job = pool.apply_async(cfg3_small_solves)
    cfg3 = risk_sweep(card, opts, evar_job)
    stamp("8a done")
    ref_p = ref_p.get()
    small_job.wait()

    # ---- 7e. the wider class's solutions ----
    wide = wide_solutions(wide_state, wide, ws, card, device, ref_p)
    stamp("7e done")

    # ---- 8b-8d: the AV@R_0.5 row on the three paths and the step kernels
    # at B = 1 (8b), the seven rows at N = 4 against float64 (8c), record
    # mode (8d) ----
    cfg3["paths"], cfg = cfg3_paths(card, opts)
    step_rows3, cfg3["step"] = cfg3_step_rows(cfg, card, opts)
    for row in step_rows3:
        row["launches"] = cfg3["step_launches"]
    kernels += step_rows3
    stamp("8b done")
    cfg3["small"] = cfg3_small(card, small_job, cfg3_refs)
    stamp("8c done")
    cfg3["record"] = record_checks(data, meta, x0, card, opts)
    stamp("8d done")

    # ---- 9. BASELINE config 4 (7,174,453 nodes): the kernels on it (9a),
    # its cold solve through bigtree on the one-card NCCL mesh (9b), the
    # headline farm lane-sharded on that mesh (9c) ----
    spec4, data4, meta4, cfg4 = cfg4_build(card)
    rows4, cfg4["step"] = cfg4_rows(spec4, data4, meta4, card, opts)
    stamp("9a done")
    cfg4["solve"] = cfg4_solve(data4, meta4, card, opts)
    del data4, meta4
    torch.cuda.empty_cache()
    stamp("9b done")
    cfg4["lanes"] = lane_farm(data, meta, x0, ws, card)
    stamp("9c done")
    # config 4's rows carry the launches of config 4's own path, its solve:
    # the composed path, which launches none of them (9b holds that).  They
    # are the only rows exempt from the launch check; their kernels'
    # launches on the main path are in the rows without the tag
    counter = dict(sp_step_fused_tau1="sp_step_fused",
                   sp_step_backtrack="sp_step_backtrack",
                   **{k: k for k in SWEEP_KERNELS})
    for row in rows4:
        row["launches"] = cfg4["solve"]["launches"].get(
            counter[row["name"].split("[")[0]], 0)
    print(f"[cfg4] rows at 0 launches, config 4's solve being the composed "
          f"path: {', '.join(row['name'] for row in rows4)} [{card}]",
          flush=True)
    check(all(k["launches"] for k in kernels),
          "a kernel row has no launches on its path")
    kernels += rows4

    result = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                  build_s=build_s, kernels=kernels, step=step_extra,
                  fused_step_farm=nums, fused_sweep_farm=snums,
                  composed_farm=cnums, cp_solve=cp, broyden_solve=broyden,
                  controls_max_err=err, profile=prof, wide=wide,
                  element_body_solves=element, ptxas=ptxas, smem_plans=plans,
                  metric_apply=metric_extra, risk_sweep=cfg3, bigtree=cfg4)
    os.makedirs("build", exist_ok=True)
    with open(os.path.join("build", "chip_smoke.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
