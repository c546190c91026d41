#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``spock_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. environment: the card's name and power limit (nvidia-smi), the torch and
   CUDA versions, and the TF32 switches, which must be off;
2. build: every kernel under ``spock_tpu_torch/csrc`` with nvcc for sm_90a;
3. each kernel against its plain PyTorch version at the shapes of the main
   path (B = 128 lanes of server_heat N=10 nx=nu=20 d=2, float32), and both
   timed with CUDA events;
4. the main path: ``mpc.simulate_async``, the warm-started async MPC farm of
   B = 128 server_heat chains at tol 1e-3 (a cold phase of 2 steps, then a
   warm phase of 24 steps chained from its state), with the kernel launch
   counts set to 0 just before and read just after;
5. the solution: the float32 root controls of a cold 1-step farm on the card
   from the warm phase's states against the port's own float64 solve on the
   CPU (tol 1e-5) for 2 lanes;
6. where the time goes: ``torch.profiler`` over 10 warm farm iterations
   (device time per iteration, kernels per iteration, the top kernels).

The last lines are one JSON object per kernel and the result line
``{"ok": true, "device": {...}}``.  Numbers also go to
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
CONTROLS_TOL = 1e-4  # BASELINE.json: f32 root controls vs a float64 solve
KERNEL_RTOL = 1e-5  # max|kernel - plain| <= 1e-5 (1 + max|plain|) per block
TIMING_REPS = 50
SPIN_CYCLES = 20_000_000  # ~10 ms at the H100's clocks: longer than any enqueue
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores


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


def random_dual(meta, batch, rng, dtype, device):
    from spock_tpu_torch.ops.cuda_kernels import block_shapes
    from spock_tpu_torch.zv import Dual

    return Dual(**{
        k: torch.tensor(rng.standard_normal(s), dtype=dtype, device=device)
        for k, s in block_shapes(meta, batch).items()})


def kernel_check(data, meta, card):
    """Phase 3: prox_h_conj kernel against its plain version at B lanes."""
    from spock_tpu_torch.ops import cuda_kernels, prox
    from spock_tpu_torch.problem import step_size
    from spock_tpu_torch.zv import DUAL_BLOCKS, leaves

    v = random_dual(meta, B, np.random.default_rng(0), data.dtype, data.device)
    sigma = step_size(data)
    got = cuda_kernels.prox_h_conj_fused(data, meta, v, sigma)
    ref = prox.prox_h_conj(data, meta, v, sigma)
    torch.cuda.synchronize()
    max_err = 0.0
    for name in DUAL_BLOCKS:
        g, r = getattr(got, name), getattr(ref, name)
        err = float((g - r).abs().max())
        scale = 1.0 + float(r.abs().max())
        check(err <= KERNEL_RTOL * scale,
              f"prox_h_conj kernel disagrees on {name}: {err} > "
              f"{KERNEL_RTOL} * {scale}")
        max_err = max(max_err, err)
    kernel_ms = time_ms(
        lambda: cuda_kernels.prox_h_conj_fused(data, meta, v, sigma))
    plain_ms = time_ms(lambda: prox.prox_h_conj(data, meta, v, sigma))
    # least time: each input read once, each output written once
    elem = data.dtype.itemsize
    n_vals = sum(a.numel() for a in leaves(v))
    nbytes = (2 * n_vals + 2 * meta.nx + 2 * meta.nu) * elem
    ops = 6 * n_vals  # scale, shift, square/compare, subtract, scale back
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
    print(f"[kernel] prox_h_conj B={B} max_abs_err={max_err:.3e} "
          f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB) [{card}]", flush=True)
    return dict(
        name="prox_h_conj",
        route="cuda",
        source="spock_tpu_torch/csrc/prox_h_conj.cu",
        replaces="spock_tpu/ops/pallas_kernels.py:175::prox_h_conj_fused",
        launches=None,
        max_abs_err=max_err,
        max_err=max_err,
        ms=kernel_ms,
        kernel_ms=kernel_ms,
        plain_ms=plain_ms,
        bound_ms=bound_ms,
        bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= ops / FP32_OPS_PER_S
        else "operations",
        library_ms=None,
    )


def main_path(data, meta, x0, ws, card, device):
    """Phase 4: cold then warm async farm.  Returns the warm result and the
    numbers of the run."""
    from spock_tpu_torch import mpc

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    res1 = mpc.simulate_async(data, meta, x0, ws, TOL, n_steps=COLD_STEPS,
                              max_total_iters=COLD_CAP, device=device)
    sync()
    cold_s = time.perf_counter() - t0
    check(bool((res1.steps_done == COLD_STEPS).all()),
          f"cold phase incomplete after {res1.total_iterations} farm "
          f"iterations: steps_done={res1.steps_done.tolist()}")
    t0 = time.perf_counter()
    res2 = mpc.simulate_async(data, meta, res1.xs, ws, TOL, n_steps=WARM_STEPS,
                              max_total_iters=WARM_CAP, z0=res1.z, v0=res1.v,
                              device=device)
    sync()
    warm_s = time.perf_counter() - t0
    check(bool((res2.steps_done == WARM_STEPS).all()),
          f"warm phase incomplete after {res2.total_iterations} farm "
          f"iterations: steps_done={res2.steps_done.tolist()}")
    iters = res2.iters_per_step[:WARM_STEPS].double().cpu().numpy()
    nums = dict(
        cold_farm_iterations=res1.total_iterations,
        cold_wall_s=cold_s,
        warm_farm_iterations=res2.total_iterations,
        warm_wall_s=warm_s,
        warm_solves=int(res2.steps_done.sum()),
        solves_per_s=int(res2.steps_done.sum()) / warm_s,
        mean_iters_per_solve=float(iters.mean()),
        p99_iters=float(np.percentile(iters, 99)),
        ms_per_farm_iteration=1e3 * warm_s / res2.total_iterations,
    )
    print(f"[main path] cold {COLD_STEPS} steps: "
          f"{res1.total_iterations} farm iterations in {cold_s:.2f} s; warm "
          f"{WARM_STEPS} steps: {res2.total_iterations} farm iterations in "
          f"{warm_s:.2f} s -> {nums['solves_per_s']:.2f} solves/s, mean "
          f"{nums['mean_iters_per_solve']:.2f} / p99 {nums['p99_iters']:.1f} "
          f"iterations per solve, {nums['ms_per_farm_iteration']:.2f} ms per "
          f"farm iteration [{card}]", flush=True)
    return res1, res2, nums


def solution_check(data, meta, spec, xs, ws, card, device):
    """Phase 5: f32 root controls of a cold 1-step farm against the port's
    float64 CPU solve (plain versions)."""
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
    return err


def profile_farm(data, meta, res2, ws, card, wall_ms_per_iter):
    """Phase 6: device time and kernel mix of PROFILE_ITERS warm farm
    iterations (a measurement: a profiler that sees no device time reports
    "not measured")."""
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
    prox_ms = sum(k[0] for k in kernels if "prox_h_conj" in k[2]) / 1e3 / iters
    out = dict(device_ms_per_iter=device_ms,
               device_kernels_per_iter=launches,
               wall_ms_per_iter_unprofiled=wall_ms_per_iter,
               device_busy_share=device_ms / wall_ms_per_iter,
               prox_h_conj_ms_per_iter=prox_ms, top=top)
    print(f"[profile] per farm iteration: device {device_ms:.3f} ms in "
          f"{launches:.0f} kernels, wall {wall_ms_per_iter:.2f} ms -> device "
          f"busy {100 * out['device_busy_share']:.1f}%; prox_h_conj "
          f"{prox_ms:.3f} ms [{card}]", flush=True)
    for t in top:
        print(f"[profile]   {t['ms_per_iter']:.3f} ms/iter "
              f"{t['calls_per_iter']:.1f} calls/iter  {t['name']}",
              flush=True)
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; nothing was run")
    import spock_tpu_torch
    from spock_tpu_torch import build
    from spock_tpu_torch.models import server_heat
    from spock_tpu_torch.ops import _build, cuda_kernels

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
    kernels = [kernel_check(data, meta, card)]

    # ---- 4. the main path ----
    rng = np.random.default_rng(0)
    x0 = torch.tensor(rng.uniform(-0.6, 0.6, (B, meta.nx)),
                      dtype=torch.float32, device=device)
    ws = torch.tensor(rng.integers(0, D, size=(COLD_STEPS + WARM_STEPS, B)),
                      device=device)
    cuda_kernels.LAUNCHES = 0
    res1, res2, nums = main_path(data, meta, x0, ws, card, device)
    launches = cuda_kernels.LAUNCHES
    farm_iters = res1.total_iterations + res2.total_iterations
    print(f"[main path] prox_h_conj launches {launches} over {farm_iters} "
          f"farm iterations ({launches / farm_iters:.2f} per iteration)",
          flush=True)
    check(launches >= farm_iters,
          f"prox_h_conj kernel launched {launches} times in {farm_iters} farm "
          "iterations")
    kernels[0]["launches"] = launches

    # ---- 5. the solution ----
    err = solution_check(data, meta, spec, res2.xs, ws, card, device)

    # ---- 6. where the time goes ----
    prof = profile_farm(data, meta, res2, ws, card,
                        nums["ms_per_farm_iteration"])

    os.makedirs("build", exist_ok=True)
    with open(os.path.join("build", "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, torch=torch.__version__,
                       cuda=torch.version.cuda, build_s=build_s,
                       kernels=kernels, main_path=nums,
                       launches_per_farm_iteration=launches / farm_iters,
                       controls_max_err=err, profile=prof), f, indent=1)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
