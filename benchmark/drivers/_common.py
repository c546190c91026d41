"""What the drivers share: the program's problem built from a
configuration, seeded draws on the run's device, the reference's problem."""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def build(run: dict, log):
    """The program's problem from the configuration: its model's spec from
    the shape, then the offline build on the run's device, timed into
    ``run["build_s"]``.  Returns (data, meta)."""
    from spock_tpu_torch import build as build_problem

    cfg = run["config"]
    shape = cfg["shape"]
    model = importlib.import_module(f"spock_tpu_torch.models.{cfg['model']}")
    spec = model.make_spec(N=shape["N"], nx=shape["nx"], d=shape["d"],
                           alpha=shape["alpha"])
    t0 = time.perf_counter()
    data, meta = build_problem(spec, dtype=DTYPES[cfg["dtype"]],
                               device=run["device"])
    if run["device"].type == "cuda":
        torch.cuda.synchronize(run["device"])
    run["build_s"] = time.perf_counter() - t0
    log(f"[bench] build {run['build_s']:.3f} s: {cfg['model']} {shape}")
    return data, meta


def generator(run: dict, salt: int = 0) -> torch.Generator:
    """A generator on the run's device, seeded from --seed (and ``salt``,
    for a stream of its own)."""
    g = torch.Generator(device=run["device"])
    g.manual_seed((int(run["seed"]) * 1_000_003 + salt) % (2 ** 63))
    return g


def uniform(g, shape, half_width, dtype, device):
    """U(-half_width, half_width) draws, made in float64 on the device."""
    u = torch.rand(shape, generator=g, dtype=torch.float64, device=device)
    return ((2.0 * u - 1.0) * half_width).to(dtype)


def host_rng(run: dict, salt: int) -> np.random.Generator:
    """A host generator for the check's samples, from --seed."""
    return np.random.default_rng([int(run["seed"]) % (2 ** 63), salt])


def reference_problem(run: dict):
    """The plain reference's problem in float64 on the run's device."""
    from ..reference import mpc

    cfg = run["config"]
    model = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
    return mpc.Problem.of(model.make(cfg), torch.float64, run["device"])


def free_program(run: dict) -> None:
    """Drop what the program keeps between calls (its graphs and their
    pools) before the reference runs."""
    from spock_tpu_torch import mpc

    mpc.clear_graphs()
    if run["device"].type == "cuda":
        torch.cuda.synchronize(run["device"])
        torch.cuda.empty_cache()


def retrials() -> tuple:
    """(lanes that backtracked, trials made): the step kernels' device
    counter (a host sync)."""
    from spock_tpu_torch.ops import spstep

    return spstep.retrials()
