"""CPU tests of the benchmark's harness at a tiny size: cells, mixes,
configurations and metrics found by name; the result line; the imports of
the harness and the reference; the frozen byte counts of the step
kernels; the reference against the program's own float64 solve; faults
planted under a run turn ``correct`` false.  Card-only tests carry the
``cuda`` marker and skip here.

    python -m pytest benchmark/tests -p no:cacheprovider
"""

from __future__ import annotations

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import core, roofline
from benchmark.reference import mpc as ref_mpc
from benchmark.reference import server_heat as ref_model
from benchmark.tests import tiny

SEED = 2 ** 33 + 12345
BENCH = tiny.BENCH


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tiny.make_root(tmp_path_factory.mktemp("checkout"))
    # a per-layer metric added as a file and an entry, no edit
    (r / "benchmark" / "metrics" / "tiny_extra.cold.py").write_text(
        "def read(run):\n    return float(run['solves'])\n")
    bench = json.loads((r / "BENCHMARK.json").read_text())
    bench["per_layer"].append(dict(
        name="tiny_extra.cold", unit="solves", better="higher",
        source="program_counter", layer="SuperMann", moves="cold_solve_s",
        workloads=["tiny.cold"]))
    (r / "BENCHMARK.json").write_text(json.dumps(bench))
    return r


def _run(root, cell, trace=False, seconds=0.5):
    return core.run_cell(root, cell, SEED, seconds, trace, device="cpu",
                         log=lambda m: None)


@pytest.mark.parametrize("trace", [False, True])
def test_cell_found_by_name_and_result_keys(root, trace):
    out = _run(root, "tiny.cold", trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    assert list(out) == keys + ["check"]
    assert out["correct"] is True
    names = set(out["metrics"])
    if trace:
        assert {"tiny_extra.cold", "iters_per_solve.cold",
                "build_s"} <= names
        assert out["metrics"]["tiny_extra.cold"]["value"] == out["attempted"]
    else:
        assert names == {"cold_solve_s", "setup_s"}
    assert set(out["check"]) == {"u_gap", "obj_gap", "dyn_gap"}
    for v in out["check"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(out)


@pytest.mark.parametrize("cell", ["tiny.farm", "tiny.loop"])
def test_drivers_correct(root, cell):
    out = _run(root, cell, seconds=3.0)
    assert out["correct"] is True, out["check"]
    assert out["attempted"] > 0
    # the window holds whole runs: S steps a lane
    mix = tiny.MIXES[cell.split(".")[1]]
    assert out["attempted"] % (mix["run_steps"] * mix.get("lanes", 1)) == 0


def _top_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_anywhere_and_reference_independent():
    files = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    assert files
    for p in files:
        assert not _top_names(p) & {"jax", "jaxlib", "flax", "spock_tpu"}, p
    for p in (BENCH / "reference").glob("*.py"):
        assert not _top_names(p) & {"spock_tpu_torch", "spock_tpu"}, p


def test_forbidden_modules_compared_whole(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "spock_tpu_torch_x", types.ModuleType("x"))
    assert "spock_tpu" not in core.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "spock_tpu", types.ModuleType("spock_tpu"))
    assert "spock_tpu" in core.forbidden_loaded()


def _bytes(tensors):
    from spock_tpu_torch.zv import leaves

    return sum(a.numel() * a.element_size() for a in leaves(tensors)
               if torch.is_tensor(a))


@pytest.mark.parametrize("cached", [0.0, 0.5, 1.0])
def test_step_bytes_match_the_tensors(cached):
    """The frozen counts against the bytes of the step kernels' real inputs
    and outputs on a tiny problem, with cached and looping lanes."""
    from spock_tpu_torch import build
    from spock_tpu_torch.algorithms import supermann as sp
    from spock_tpu_torch.models import server_heat
    from spock_tpu_torch.ops import spstep
    from spock_tpu_torch.solver import zero_dual, zero_primal

    shape = dict(N=3, nx=3, d=2)
    data, meta = build(server_heat.make_spec(N=3, nx=3, d=2),
                       dtype=torch.float32, device="cpu")
    B = 4
    assert roofline.pair_values(shape) == meta.nz + meta.nv
    x0 = torch.full((B, 3), 0.3)
    c = sp.sp_init_fused(meta, x0, zero_primal(meta, (B,), device="cpu"),
                         zero_dual(meta, (B,), device="cpu"))
    flags = torch.arange(B) < int(cached * B)
    args = sp.step_inputs(c, sp.SuperMannOpts(), 0, ~c.done, flags,
                          c.r_safe, torch.ones(B))
    out = spstep.sp_step_fused(data, meta, *args, 1.0, 1.0, c1=0.99,
                               sigma_k2=0.1, lam=1.0, lam_sp=1.0)
    pair = _bytes(args[:2])
    want = (_bytes(args) - (1.0 - cached) * pair + _bytes(out[:7]))
    got, _ = roofline.step_launch(shape, B, cached)
    assert got == pytest.approx(want)
    # backtrack: k looping lanes read z, d, zbar and write z_new and s once
    k = 3
    nb, _ = roofline.backtrack_launches(shape, B, 1, k, 5)
    assert nb == pytest.approx(5 * k * pair / B + B * 2 * 16 * 4)


def test_reference_matches_the_programs_float64_solve():
    from spock_tpu_torch import Solver, build
    from spock_tpu_torch.models import server_heat

    cfg = dict(shape=dict(N=4, nx=3, d=2, p=[0.3, 0.7], alpha=0.95))
    P = ref_mpc.Problem.of(ref_model.make(cfg))
    x0 = np.random.default_rng(1).uniform(-0.6, 0.6, (3, 3))
    sol = ref_mpc.solve(P, torch.tensor(x0))
    assert sol.converged
    data, meta = build(server_heat.make_spec(N=4, nx=3, d=2),
                       dtype=torch.float64, device="cpu")
    res = Solver(data, meta, device="cpu", max_iter=20000).solve(
        torch.tensor(x0), tol=1e-9)
    assert bool((res.status == 0).all())
    assert float((res.z.u[:, :, 0] - sol.u0).abs().max()) < 1e-7
    assert float((res.z.s[:, 0] - sol.value).abs().max()) < 1e-7


def _unchanged(monkeypatch):
    """A solve that returns its warm start unchanged (zeros when cold)."""
    import dataclasses

    from spock_tpu_torch import mpc, solver
    from spock_tpu_torch.zv import tmap

    real = solver.Solver.solve

    def solve(self, x0, z0=None, v0=None, tol=1e-3):
        res = real(self, x0, z0, v0, tol)
        z = z0 if z0 is not None else tmap(torch.zeros_like, res.z)
        return dataclasses.replace(res, z=z, v=res.v if v0 is None else v0)

    monkeypatch.setattr(solver.Solver, "solve", solve)
    real_bodies = mpc._bodies

    def bodies(*a, **k):
        def stuck(body):
            def run(c):
                new = body(c)
                return type(new)(**{**new.__dict__, "z": c.z, "v": c.v})
            return run
        return [stuck(b) for b in real_bodies(*a, **k)]

    monkeypatch.setattr(mpc, "_bodies", bodies)


def _altered(monkeypatch):
    """The applied control altered where it is produced."""
    from spock_tpu_torch import solver
    from spock_tpu_torch.algorithms import supermann as sp

    real = solver.Solver.solve

    def solve(self, x0, z0=None, v0=None, tol=1e-3):
        res = real(self, x0, z0, v0, tol)
        res.z.u[..., 0] += 0.05
        return res

    monkeypatch.setattr(solver.Solver, "solve", solve)
    real_u = sp.root_u_carry
    monkeypatch.setattr(sp, "root_u_carry", lambda c: real_u(c) + 0.05)


def _half(monkeypatch):
    """Half of the farm's lanes left out: they never move."""
    from spock_tpu_torch import mpc

    real_bodies = mpc._bodies

    def bodies(*a, **k):
        def half(body):
            def run(c):
                new = body(c)
                B = c.done.shape[0]
                keep = torch.arange(B) >= B // 2
                return type(new)(**{**new.__dict__, "done": torch.where(
                    keep, new.done, torch.zeros_like(new.done))})
            return run
        return [half(b) for b in real_bodies(*a, **k)]

    monkeypatch.setattr(mpc, "_bodies", bodies)


@pytest.mark.parametrize("fault,cell", [
    (_unchanged, "tiny.farm"), (_unchanged, "tiny.loop"),
    (_unchanged, "tiny.cold"), (_altered, "tiny.farm"),
    (_altered, "tiny.loop"), (_altered, "tiny.cold"),
    (_half, "tiny.farm")])
def test_fault_turns_correct_false(root, monkeypatch, fault, cell):
    fault(monkeypatch)
    try:
        out = _run(root, cell, seconds=3.0)
    except RuntimeError:
        return  # a fault the run itself refuses: no result, not correct
    assert out["correct"] is False, out["check"]


@pytest.mark.parametrize("mix", ["farm", "loop", "cold"])
def test_control_fails(mix):
    """The reference put in the program's place in TF32 (its products'
    operands rounded to 10 mantissa bits) fails the tiny cells' limits on
    three seeds; float32 passes them."""
    from benchmark import control

    for seed in (SEED, SEED + 1, SEED + 2):
        r = control.readings(tiny.CONFIG, tiny.MIXES[mix], seed, 2,
                             device="cpu")
        assert any(r[k] > v for k, v in tiny.LIMITS[mix].items()
                   if k in r), r
