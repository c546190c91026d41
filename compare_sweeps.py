#!/usr/bin/env python3
"""Times the CP sweep kernels of one checkout of the PyTorch/CUDA port and
the farms that run them, on one NVIDIA GPU, so that two checkouts can be
compared on one card within one call.

    python3 compare_sweeps.py [CHECKOUT] [LABEL]

CHECKOUT is the root of a checkout whose ``spock_tpu_torch`` is measured
(default: this one); its kernels are built into its own ``build/``.  The
measurement code is this file's and this checkout's ``chip_smoke.py``
(``time_ms``, ``farm``, ``wide_specs``), whatever CHECKOUT holds.  For the
headline (server_heat N=10 nx=nu=20 d=2, B = 128, float32) and
``server_heat_poly_navar_pncost`` it prints, on one JSON line, the median
CUDA-event milliseconds of cp_sweep_fused, cp_sweep_metric_fused and
candidate_sweep_fused on random inputs (chip_smoke.py's phase 3 inputs),
and the ms per farm iteration of the warm farm on the sweep kernels (the
headline with ``fused_step=False``, chip_smoke.py's phase 4b; ``_pncost`` on
its default path, phase 7d), with the card's name and power limit.  To
compare a change with its parent, run parent, change, change, parent in one
call.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
CHECKOUT = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
LABEL = sys.argv[2] if len(sys.argv) > 2 else str(CHECKOUT)


def _chip_smoke():
    """This checkout's chip_smoke.py, whichever package it then imports."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_ms(cs, data, meta):
    """Median ms of the three sweep kernels at B lanes on random inputs."""
    from spock_tpu_torch.ops import sweep_kernels
    from spock_tpu_torch.problem import step_size

    rng = np.random.default_rng(1)

    def pair():
        return sweep_kernels.new_pair(meta, cs.B, lambda s: torch.tensor(
            rng.standard_normal(s), dtype=data.dtype, device=data.device))

    (z, v), (dz, dv) = pair(), pair()
    x0 = torch.tensor(rng.uniform(-0.6, 0.6, (cs.B, meta.nx)),
                      dtype=data.dtype, device=data.device)
    tau = torch.tensor(rng.random(cs.B), dtype=data.dtype, device=data.device)
    g = step_size(data)
    calls = {
        "cp_sweep_fused": lambda: sweep_kernels.cp_sweep_fused(
            data, meta, z, v, g, g, x0),
        "cp_sweep_metric_fused": lambda: sweep_kernels.cp_sweep_metric_fused(
            data, meta, z, v, g, g, x0),
        "candidate_sweep_fused": lambda: sweep_kernels.candidate_sweep_fused(
            data, meta, z, v, dz, dv, tau, g, g, x0),
    }
    return {name: cs.time_ms(fn) for name, fn in calls.items()}


def main():
    if not torch.cuda.is_available():
        sys.exit("compare_sweeps: no CUDA device; nothing was run")
    t0 = time.perf_counter()
    cs = _chip_smoke()
    sys.path.insert(0, str(CHECKOUT))
    from spock_tpu_torch import build
    from spock_tpu_torch.models import server_heat
    from spock_tpu_torch.ops import _build

    print(f"[compare] spock_tpu_torch from "
          f"{sys.modules['spock_tpu_torch'].__file__}, measured by "
          f"{cs.__file__}", flush=True)
    _build.build_all(["cp_sweep", "metric_apply", "prox_h_conj"])
    build_s = time.perf_counter() - t0
    card = cs.card_line()
    device = torch.device("cuda")
    spec = server_heat.make_spec(N=cs.N, nx=cs.NX, d=cs.D)
    _, pncost = cs.wide_specs(spec)
    rng = np.random.default_rng(0)
    x0 = torch.tensor(rng.uniform(-0.6, 0.6, (cs.B, cs.NX)),
                      dtype=torch.float32, device=device)
    ws = torch.tensor(rng.integers(0, cs.D, size=(cs.COLD_STEPS
                                                  + cs.WARM_STEPS, cs.B)),
                      device=device)
    out = dict(label=LABEL, card=card, build_s=build_s)
    for key, s, path in (("headline", spec, dict(fused_step=False)),
                         ("pncost", pncost, {})):
        data, meta = build(s, dtype=torch.float32)
        out[f"{key}_kernel_ms"] = kernel_ms(cs, data, meta)
        _, _, nums, _ = cs.farm(data, meta, x0, ws, card, device,
                                f"{LABEL} {key} fused-sweep", cs.WARM_STEPS,
                                **path)
        out[f"{key}_farm"] = {k: nums[k] for k in (
            "ms_per_farm_iteration", "warm_farm_iterations", "solves_per_s",
            "mean_iters_per_solve", "launches_per_farm_iteration")}
    out["run_s"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
