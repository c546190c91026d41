"""The port's examples that solve (``examples/torch_*.py``), each run in a
subprocess on the CPU at its small size with ``--cpu --out-dir tmp``, and
held by its solutions: against the JAX package (its solves run in
processes of their own, ``tests/jax_ref_worker.py``) or against the port's
float64 native and ADMM oracles.  Each run must write its artifacts into
its out dir and change nothing under ``examples/output/``.

SuperMann trajectories are chaotic across packages, so no SuperMann
iterate is held beyond one iteration: solutions (controls, objectives)
are."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tests.jax_ref_worker import Ref

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"
OUTPUT = EXAMPLES / "output"
TIMEOUT_S = 300


def _snapshot():
    return {p.name: p.stat().st_mtime_ns for p in OUTPUT.iterdir()}


def run_example(name, out_dir, *args):
    """``examples/torch_<name>.py --cpu --out-dir out_dir *args`` in a
    subprocess of one thread, which must succeed and leave
    ``examples/output/`` as it was; returns the finished process."""
    before = _snapshot()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, str(EXAMPLES / f"torch_{name}.py"), "--cpu",
         "--out-dir", str(out_dir), *map(str, args)],
        cwd=REPO, env=env, capture_output=True, text=True,
        timeout=TIMEOUT_S)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert _snapshot() == before, "the example changed examples/output/"
    return out


def load(out_dir, name) -> dict:
    return json.loads((Path(out_dir) / name).read_text())


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """The JAX package's solves, started together in processes of their
    own on the first test that asks."""
    tmp = tmp_path_factory.mktemp("jax_refs")
    return {m: Ref(m, tmp) for m in ("risk_small", "mpc_small",
                                     "residuals_small")}


def _recorded(out):
    """The device line and the versions of the run."""
    assert out["card"] == "cpu" and out["device"] == "cpu"
    assert "torch" in out and "cuda" in out


def test_oracle_check(tmp_path, jax_refs):
    """Three tiers at N=3 nx=4 on a 4-lane farm: the example's own gates
    (the oracles within 1e-4 of each other, the port within 1e-3 of the
    native solve) pass, and every instance converged in all three."""
    run_example("oracle_check", tmp_path, "--horizon", 3, "--nx", 4,
                "--lanes", 4, "--workers", 2)
    out = load(tmp_path, "torch_oracle_check.json")
    _recorded(out)
    assert out["ok"] and out["oracles_ok"] and out["engine_ok"]
    assert out["paths"]["use_fused_step"]
    for row in out["instances"]:
        assert row["port_converged"] and row["native_converged"]
        assert row["admm_converged"]
        assert row["u0_err_native_vs_admm"] < 1e-4
        assert row["u0_err_port_vs_native"] < 1e-3


def test_mpc_simulation(tmp_path, jax_refs):
    """The closed loop at N=3 nx=3, 4 lanes, 3 steps, float64, tol 1e-6:
    the states and controls of ``mpc.simulate`` within 1e-4 of the JAX
    package's (two solutions at tol 1e-6, not two trajectories)."""
    run_example("mpc_simulation", tmp_path, "--horizon", 3, "--nx", 3,
                "--repeats", 4, "--steps", 3, "--f64", "--tol", 1e-6,
                "--legs", "simulate", "--warmup-runs", 0, "--trajectory")
    out = load(tmp_path, "torch_mpc_simulation.json")
    _recorded(out)
    assert out["legs"]["simulate"]["unconverged"] == 0
    got = np.load(tmp_path / "torch_mpc_simulation.npz")
    ref = jax_refs["mpc_small"].wait()
    assert (ref["status"] == 0).all()
    np.testing.assert_allclose(got["us"], ref["us"], atol=1e-4)
    np.testing.assert_allclose(got["xs"], ref["xs"], atol=1e-4)


def test_residuals(tmp_path, jax_refs):
    """The traces at nx=3 N=4, float64, tol 1e-5: CP's iterations equal
    JAX run_cp's and its whole trace within 1e-10; SuperMann's first
    iteration within 1e-12 and its final residuals below tol; the CSVs
    written."""
    run_example("residuals", tmp_path, "--nx", 3, "--horizon", 4)
    out = load(tmp_path, "torch_residuals.json")
    _recorded(out)
    ref = jax_refs["residuals_small"].wait()
    cp = np.loadtxt(tmp_path / "torch_residuals_cp.csv", delimiter=",")
    sp = np.loadtxt(tmp_path / "torch_residuals_spock.csv", delimiter=",")
    assert out["cp_iters"] == int(ref["cp_iters"]) == cp.shape[0]
    np.testing.assert_allclose(cp[:, 1:], ref["cp_trace"], rtol=1e-10,
                               atol=1e-300)
    np.testing.assert_allclose(sp[0, 1:], ref["sp_first"], rtol=1e-12,
                               atol=1e-300)
    assert sp.shape[0] == out["spock_iters"] and out["spock_converged"]
    assert max(out["spock_final_xi"]) < 1e-5


def test_profile_solve(tmp_path):
    """The car at N=3: converged, and its objective within 50 tol
    (1 + |s|) of the native float64 solve at tol 1e-6 (the bound of the
    horizon race's cross-check)."""
    from spock_tpu_torch.baselines import native
    from spock_tpu_torch.models import car

    run_example("profile_solve", tmp_path, "--horizon", 3)
    out = load(tmp_path, "torch_profile_solve.json")
    _recorded(out)
    assert out["converged"] and out["wall_s"] > 0
    nat = native.NativeSolver(car.make_spec(N=3, d=2)).solve(
        np.array([0.1, 0.1]), tol=1e-6, max_iter=20000, algorithm="spock",
        warm_start=False)
    assert nat["converged"]
    assert abs(out["objective"] - nat["objective"]) <= 50 * 1e-3 * (
        1 + abs(nat["objective"]))


def test_scaling(tmp_path):
    """The horizon race at nx=4, N=3..4: every solver converges, its own
    s_1 cross-check against the native float64 oracle finds no mismatch
    (the script would exit non-zero), and ``reduced`` records the cut."""
    run_example("scaling", tmp_path, "--nx", 4, "--nmax", 4,
                "--oracle-workers", 1, "--plot")
    out = load(tmp_path, "torch_scaling.json")
    _recorded(out)
    assert out["objective_cross_check"]["mismatches"] == []
    algs = {(r["N"], r["alg"]) for r in out["rows"] if r["converged"]}
    for N in (3, 4):
        for alg in ("spock", "cp", "native_sp", "native_cp", "admm",
                    "oracle_native_sp_1e-6"):
            assert (N, alg) in algs, (N, alg)
    assert out["reduced"]["horizons"] == [3, 4]
    assert (tmp_path / "torch_scaling.png").exists()


def test_risk_sweep(tmp_path, jax_refs):
    """``--small`` (N=4), the script's float32 at tol 1e-4, its seven rows
    in seven processes: every row converged, each objective within 2e-2
    relative of the JAX Solver's float64 solve at tol 1e-5 (at tol 1e-4
    the termination alone moves TV's objective by ~7e-3), and the risk
    ordering of the AV@R rows."""
    run_example("risk_sweep", tmp_path, "--small", "--jobs", 7)
    out = load(tmp_path, "torch_risk_sweep_small.json")
    _recorded(out)
    ref = jax_refs["risk_small"].wait()
    rows = out["rows"]
    assert [r["risk"] for r in rows] == [
        "risk_neutral", "avar[0.99]", "avar[0.9]", "avar[0.5]", "avar[0.1]",
        "tv[0.3]", "evar[0.5]"]
    assert all(r["converged"] for r in rows)
    got = np.array([r["objective"] for r in rows])
    np.testing.assert_allclose(got, ref["objective"], rtol=2e-2)
    assert all(a <= b + 2e-2 * abs(b) for a, b in zip(got[1:4], got[2:5]))
    assert not rows[-1]["paths"]["use_fused_step"]  # EVaR: composed
