#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``spock_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. environment: the card's name and power limit (nvidia-smi), the torch and
   CUDA versions, and the TF32 switches, which must be off;
2. build: every kernel under ``spock_tpu_torch/csrc`` with nvcc for sm_90a,
   one nvcc per source, all started together;
3. each kernel against its plain PyTorch version at the shapes of the main
   path (B = 128 lanes of server_heat N=10 nx=nu=20 d=2, float32), and both
   timed with CUDA events: prox_h_conj, cp_sweep_fused,
   cp_sweep_metric_fused, candidate_sweep_fused and metric_apply_fused;
4. the paths, each driven with every kernel launch count set to 0 just
   before it and read just after:
   a. the main path, ``mpc.simulate_async`` on the fused sweep: the
      warm-started async MPC farm of B = 128 server_heat chains at tol 1e-3
      (a cold phase of 2 steps, then a warm phase of 24 steps chained from
      its state), where every CP sweep is one launch of a sweep kernel;
   b. the same farm on the composed path (``fused_sweep=False``), whose
      prox_h* phase is the prox_h_conj kernel;
   c. ``Solver(algorithm="cp")``, one cp_sweep_fused launch per iteration,
      and d. ``Solver`` with Broyden directions, one metric_apply_fused
      launch per iteration, both warm-started from 4 lanes of the farm at
      its final states;
5. the solution: the float32 root controls of a cold 1-step fused farm on
   the card from the warm phase's states against the port's own float64
   solve on the CPU (tol 1e-5) for 2 lanes, and the controls of 4c and 4d
   at the same states against the same solve;
6. where the time goes: ``torch.profiler`` over 10 warm farm iterations of
   the fused path (device time per iteration, kernels per iteration, the top
   kernels).

The last lines are the card, one JSON object with a row per kernel, and the
result line ``{"ok": true, "device": {...}}``.  Numbers also go to
``build/chip_smoke.json``.  The script imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

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


def time_ms(fn, reps=TIMING_REPS, warmup=5):
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
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate and
    the operations over the float32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def nbytes_of(tensors):
    return sum(a.numel() * a.element_size() for a in tensors)


def hold(name, got, ref, scales=None):
    """max|kernel - plain| over the output leaves; each must lie within
    KERNEL_RTOL (1 + scale), scale = max|plain| unless given."""
    from spock_tpu_torch.zv import leaves

    got, ref = leaves(got), leaves(ref)
    check(len(got) == len(ref), f"{name}: {len(got)} outputs, plain {len(ref)}")
    max_err = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        check(bool(torch.isfinite(g).all()), f"{name}: output {i} not finite")
        err = float((g - r).abs().max())
        scale = (scales or {}).get(i, float(r.abs().max()))
        check(err <= KERNEL_RTOL * (1.0 + scale),
              f"{name} kernel disagrees on output {i}: {err} > "
              f"{KERNEL_RTOL} * (1 + {scale})")
        max_err = max(max_err, err)
    return max_err


def kernel_row(name, source, replaces, max_err, kernel_ms, plain_ms,
               nbytes, ops, card):
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
    l_ops = 2 * (n_nl * ny + n_nr * (nx * nx + nu * nu) + n_lf * nx * nx)
    ops = 2 * l_ops + 2 * pair  # one L and one L' application: M
    if sweep:
        mker = ny + 2 * d
        ops += 2 * n_nl * (2 * d * nx * nu + nu * nu + d * nx * nx + nu * nx)
        ops += 2 * n_nl * (nu * nx + d * nx * nx + d * nx * nu)
        ops += 2 * n_nl * mker * mker + 10 * pair
        ops += (2 * l_ops + 4 * pair) * (int(metric) + int(direction))
    return ops


def sweep_kernel_checks(data, meta, card):
    """Phase 3: the four whole-sweep kernels against their plain versions."""
    from spock_tpu_torch.algorithms import common
    from spock_tpu_torch.ops import linop, sweep_kernels
    from spock_tpu_torch.problem import step_size
    from spock_tpu_torch.zv import leaves, sub

    rng = np.random.default_rng(1)
    shapes = sweep_kernels.pair_shapes(meta, B)

    def pair():
        return sweep_kernels._pair([
            torch.tensor(rng.standard_normal(s), dtype=data.dtype,
                         device=data.device) for s in shapes])

    (z, v), (dz, dv) = pair(), pair()
    x0 = torch.tensor(rng.uniform(-0.6, 0.6, (B, meta.nx)), dtype=data.dtype,
                      device=data.device)
    tau = torch.tensor(rng.random(B), dtype=data.dtype, device=data.device)
    g = s = step_size(data)
    w = (sweep_kernels._pair([a + tau.reshape((B,) + (1,) * (a.ndim - 1)) * b
                              for a, b in zip(leaves((z, v)),
                                              leaves((dz, dv)))]))
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
            # the dot products: their rounding scales with sum |a_i b_i|
            base = (z, v) if name == "cp_sweep_metric_fused" else w
            r = sub(base, (ref[0], ref[1]))
            scales[34] = float(sum(
                (a.abs() * b.abs()).flatten(1).sum(1)
                for a, b in zip(leaves(r), leaves(ref[2:4]))).max())
            if name == "candidate_sweep_fused":
                md = linop.metric_apply(data, meta, dz, dv, g, s)
                scales[37] = float(sum(
                    (a.abs() * b.abs()).flatten(1).sum(1)
                    for a, b in zip(leaves(r), leaves(md))).max())
        max_err = hold(name, got, ref, scales)
        used = consts[:4] if name == "metric_apply_fused" else consts
        nbytes = nbytes_of(leaves(tuple(inputs)) + leaves(got) + used)
        ops = B * sweep_ops(meta, name != "cp_sweep_fused",
                            name == "candidate_sweep_fused",
                            sweep=name != "metric_apply_fused")
        source, replaces = SWEEP_KERNELS[name]
        rows.append(kernel_row(name, source, replaces, max_err,
                               time_ms(kernel), time_ms(plain), nbytes, ops,
                               card))
    return rows


def launch_counts():
    from spock_tpu_torch.ops import cuda_kernels, sweep_kernels

    return dict(sweep_kernels.LAUNCHES, prox_h_conj=cuda_kernels.LAUNCHES)


def reset_counts():
    from spock_tpu_torch.ops import cuda_kernels, sweep_kernels

    cuda_kernels.LAUNCHES = 0
    for k in sweep_kernels.LAUNCHES:
        sweep_kernels.LAUNCHES[k] = 0


def farm(data, meta, x0, ws, card, device, fused_sweep, warm_steps):
    """Phase 4a/4b: cold then warm async farm, with the launch counts set to
    0 just before and read just after.  Returns the warm result, the numbers
    of the run and the counts."""
    from spock_tpu_torch import mpc

    label = "fused" if fused_sweep else "composed"

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    res1 = mpc.simulate_async(data, meta, x0, ws, TOL, n_steps=COLD_STEPS,
                              max_total_iters=COLD_CAP, device=device,
                              fused_sweep=fused_sweep)
    sync()
    cold_s = time.perf_counter() - t0
    check(bool((res1.steps_done == COLD_STEPS).all()),
          f"{label} cold phase incomplete after {res1.total_iterations} farm "
          f"iterations: steps_done={res1.steps_done.tolist()}")
    t0 = time.perf_counter()
    res2 = mpc.simulate_async(data, meta, res1.xs, ws, TOL, n_steps=warm_steps,
                              max_total_iters=WARM_CAP, z0=res1.z, v0=res1.v,
                              device=device, fused_sweep=fused_sweep)
    sync()
    warm_s = time.perf_counter() - t0
    counts = launch_counts()
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
    print(f"[{label} farm] launches over {farm_iters} farm iterations: {per}",
          flush=True)
    return res1, res2, nums, farm_iters


def solution_check(data, meta, spec, xs, ws, card, device):
    """Phase 5: f32 root controls of a cold 1-step fused farm against the
    port's float64 CPU solve (plain versions).  Returns the error and the
    reference controls."""
    from spock_tpu_torch import build, mpc
    from spock_tpu_torch.solver import Solver

    res = mpc.simulate_async(data, meta, xs, ws, TOL, n_steps=1,
                             max_total_iters=COLD_CAP, device=device)
    check(bool((res.steps_done == 1).all()), "cold 1-step farm incomplete")
    u_f32 = res.us[0, :CHECK_LANES].double().cpu().numpy()
    data64, meta64 = build(spec, dtype=torch.float64, device="cpu")
    ref = Solver(data64, meta64, algorithm="spock", max_iter=5000,
                 device="cpu").solve(
        xs[:CHECK_LANES].double().cpu(), tol=1e-5)
    check(bool(ref.converged.all()), "float64 CPU reference did not converge")
    u_ref = ref.z.u[:, :, 0].numpy()
    err = float(np.abs(u_f32 - u_ref).max())
    print(f"[solution] controls_max_err={err:.3e} over {CHECK_LANES} lanes "
          f"(f32 card farm vs f64 CPU solve, limit {CONTROLS_TOL}) [{card}]",
          flush=True)
    check(err <= CONTROLS_TOL, f"controls_max_err {err} > {CONTROLS_TOL}")
    return err, u_ref


def solver_run(data, meta, res2, card, label, kernel, **solver_kw):
    """Phase 4c/4d: a Solver run warm-started from SOLVE_LANES lanes of the
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


def profile_farm(data, meta, res2, ws, card, wall_ms_per_iter):
    """Phase 6: device time and kernel mix of PROFILE_ITERS warm farm
    iterations on the fused path (a measurement: a profiler that sees no
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
    sweep_ms = sum(k[0] for k in kernels if "cp_sweep_kernel" in k[2]) / 1e3 / iters
    out = dict(device_ms_per_iter=device_ms,
               device_kernels_per_iter=launches,
               wall_ms_per_iter_unprofiled=wall_ms_per_iter,
               device_busy_share=device_ms / wall_ms_per_iter,
               sweep_kernel_ms_per_iter=sweep_ms, top=top)
    print(f"[profile] fused farm, per farm iteration: device {device_ms:.3f} "
          f"ms in {launches:.0f} kernels, wall {wall_ms_per_iter:.2f} ms -> "
          f"device busy {100 * out['device_busy_share']:.1f}%; sweep kernel "
          f"{sweep_ms:.3f} ms [{card}]", flush=True)
    for t in top:
        print(f"[profile]   {t['ms_per_iter']:.3f} ms/iter "
              f"{t['calls_per_iter']:.1f} calls/iter  {t['name']}",
              flush=True)
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; nothing was run")
    import spock_tpu_torch
    from spock_tpu_torch import SuperMannOpts, build
    from spock_tpu_torch.models import server_heat
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

    # ---- 2. build ----
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    for name, (sec, log) in _build.BUILD_LOG.items():
        print(f"[build] {name}: nvcc {sec:.1f} s\n{log.strip()}", flush=True)
    print(f"[build] all kernels ready in {build_s:.1f} s", flush=True)

    spec = server_heat.make_spec(N=N, nx=NX, d=D)
    data, meta = build(spec, dtype=torch.float32)
    check(data.device.type == "cuda", "build() did not default to the card")

    # ---- 3. kernels against their plain versions ----
    kernels = [prox_kernel_check(data, meta, card)]
    kernels += sweep_kernel_checks(data, meta, card)
    rows = {k["name"]: k for k in kernels}

    # ---- 4a. the main path: the farm on the fused sweep ----
    rng = np.random.default_rng(0)
    x0 = torch.tensor(rng.uniform(-0.6, 0.6, (B, meta.nx)),
                      dtype=torch.float32, device=device)
    ws = torch.tensor(rng.integers(0, D, size=(COLD_STEPS + WARM_STEPS, B)),
                      device=device)
    res1, res2, nums, farm_iters = farm(data, meta, x0, ws, card, device,
                                        True, WARM_STEPS)
    counts = nums["launches"]
    check(counts["cp_sweep_metric_fused"] >= 1,
          "the fused farm never launched cp_sweep_metric_fused")
    check(counts["candidate_sweep_fused"] >= farm_iters,
          f"candidate_sweep_fused launched {counts['candidate_sweep_fused']} "
          f"times in {farm_iters} farm iterations")
    for name in ("cp_sweep_metric_fused", "candidate_sweep_fused"):
        rows[name]["launches"] = counts[name]

    # ---- 4b. the composed path (fused_sweep=False): the prox_h* kernel ----
    _, _, cnums, c_iters = farm(data, meta, x0, ws, card, device, False,
                                WARM_STEPS)
    launches = cnums["launches"]["prox_h_conj"]
    check(launches >= c_iters,
          f"prox_h_conj kernel launched {launches} times in {c_iters} farm "
          "iterations")
    check(sum(cnums["launches"][k] for k in SWEEP_KERNELS) == 0,
          "the composed path launched a sweep kernel")
    rows["prox_h_conj"]["launches"] = launches
    print(f"[paths] ms per farm iteration: fused "
          f"{nums['ms_per_farm_iteration']:.2f}, composed "
          f"{cnums['ms_per_farm_iteration']:.2f}; solves/s: fused "
          f"{nums['solves_per_s']:.2f}, composed {cnums['solves_per_s']:.2f} "
          f"[{card}]", flush=True)

    # ---- 4c/4d. the Solver's paths: cp_sweep_fused, metric_apply_fused ----
    cp, u_cp = solver_run(data, meta, res2, card, "cp solve",
                          "cp_sweep_fused", algorithm="cp", max_iter=CP_CAP)
    rows["cp_sweep_fused"]["launches"] = cp["launches"]["cp_sweep_fused"]
    broyden, u_broyden = solver_run(
        data, meta, res2, card, "broyden solve", "metric_apply_fused",
        max_iter=BROYDEN_CAP, supermann=SuperMannOpts(direction="broyden"))
    rows["metric_apply_fused"]["launches"] = (
        broyden["launches"]["metric_apply_fused"])

    # ---- 5. the solution ----
    err, u_ref = solution_check(data, meta, spec, res2.xs, ws, card, device)
    for label, u, nums_ in (("cp solve", u_cp, cp),
                            ("broyden solve", u_broyden, broyden)):
        nums_["controls_err"] = float(np.abs(u - u_ref).max())
        print(f"[solution] {label}: controls {nums_['controls_err']:.3e} "
              f"from the f64 solve (limit {SOLVE_CONTROLS_TOL}) [{card}]",
              flush=True)
        check(nums_["controls_err"] <= SOLVE_CONTROLS_TOL,
              f"{label}: controls {nums_['controls_err']} from the f64 solve")

    # ---- 6. where the time goes ----
    prof = profile_farm(data, meta, res2, ws, card,
                        nums["ms_per_farm_iteration"])

    os.makedirs("build", exist_ok=True)
    with open(os.path.join("build", "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, torch=torch.__version__,
                       cuda=torch.version.cuda, build_s=build_s,
                       kernels=kernels, fused_farm=nums, composed_farm=cnums,
                       cp_solve=cp, broyden_solve=broyden,
                       controls_max_err=err, profile=prof), f, indent=1)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
