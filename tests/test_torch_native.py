"""The port's jax-free native oracle (spock_tpu_torch/baselines/native.py):
the analogues of tests/test_native.py's tests, held against the port's own
Solver in float64 on the CPU, and against the JAX package's NativeSolver on
the same spec.

The port builds its library from native/spock_cpu.cpp with g++ into
build/spock_tpu_torch/; the JAX package loads the tracked
native/libspock_cpu.so, built elsewhere with -march=native, whose rounding
differs from this build's by ~1e-9 after a solve.  The comparison between
the two bindings therefore runs both on the port's library: the same C code
gets the same inputs, so the inputs are compared exactly and the solves at
1e-12.

The file holds five test items: pytest-xdist's ``--dist loadfile`` queues
files by their number of tests, largest first, and a short file joins the
queue's tail, behind the repository's long JAX files, whose placement on
the workers it then leaves as it was."""

import dataclasses

import numpy as np
import pytest
import torch

from spock_tpu.baselines import native as jnative
from spock_tpu_torch import build, problem, risks
from spock_tpu_torch.baselines import native
from spock_tpu_torch.baselines.native import NativeSolver, _nonleaf_perm
from spock_tpu_torch.models import car, server_heat
from spock_tpu_torch.solver import Solver
from spock_tpu_torch.tree import UniformTree
from tests.torch_parity import SMALL, port_spec

torch.set_num_threads(1)

X0_SH = np.array([0.4, -0.3, 0.5, 0.2])


def _solve(spec, x0, algorithm, tol=1e-6, max_iter=20000):
    data, meta = build(spec, dtype=torch.float64, device="cpu")
    res = Solver(data, meta, algorithm=algorithm, max_iter=max_iter,
                 device="cpu").solve(x0, tol=tol)
    assert bool(res.converged.all())
    return data, res


def _poly_spec():
    spec = server_heat.make_spec(N=4, nx=4, d=2)
    Gx = np.array([[1.0, 0.5, 0.0, 0.0], [0.0, 0.0, 1.0, -0.3]])
    return dataclasses.replace(spec, polytope=problem.Polytope(
        Gx=Gx, Gu=np.array([[0.2, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.1]]),
        lo=np.array([-1.5, -1.0]), hi=np.array([1.5, 1.0]), GxN=Gx[:1],
        loN=np.array([-1.2]), hiN=np.array([1.2])))


def _navar_spec():
    # N=3: per-node AV@R slows the float64 SuperMann solve (~2,000
    # iterations at N=4, ~40 s on one CPU thread)
    spec = server_heat.make_spec(N=3, nx=4, d=2)
    rng = np.random.default_rng(17)
    n_nl = spec.tree.n_nonleaf
    return dataclasses.replace(spec, risk=risks.avar_nonuniform(
        rng.dirichlet(np.ones(2), size=n_nl), rng.uniform(0.7, 0.99, n_nl)))


@pytest.mark.parametrize("model", ["car", "server_heat"])
def test_native_matches_port_solver(model):
    if model == "car":
        spec = car.make_spec(N=3, d=2)
        x0 = np.array([0.1, 0.1])
    else:
        spec = server_heat.make_spec(N=4, nx=4, d=2)
        x0 = X0_SH
    nat = NativeSolver(spec)
    res_n = nat.solve(x0, tol=1e-6, max_iter=20000)
    assert res_n["converged"]
    data, res = _solve(spec, x0, "cp")
    np.testing.assert_allclose(res_n["u"][0], res.z.u[:, 0].numpy(),
                               atol=2e-4)
    np.testing.assert_allclose(res_n["objective"], float(res.z.s[0]),
                               atol=2e-4)
    # the host power iteration and the port's agree on ||L||^2
    np.testing.assert_allclose(nat.L_sq, float(data.L_sq), rtol=0.05)


def test_native_wider_class_matches_port_solver():
    """Two-sided polytope rows, per-node AV@R (permuted into the C++ heap
    order) and per-dimension box bounds (the tight input bound respected),
    each against the port's SuperMann solve."""
    box = dataclasses.replace(
        server_heat.make_spec(N=3, nx=3, d=2), constraints=problem.Box(
            x_min=np.array([-0.2, -1.0, -1.0]),
            x_max=np.array([0.2, 1.0, 1.0]),
            u_min=np.array([-1.5, -0.1, -1.5]),
            u_max=np.array([1.5, 0.1, 1.5])))
    for label, spec, x0, per_node in (
            ("polytope", _poly_spec(), X0_SH, 0),
            ("nonuniform risk", _navar_spec(), X0_SH, 1),
            ("per-dimension boxes", box, np.array([0.15, -0.3, 0.5]), 0)):
        nat = NativeSolver(spec)
        assert nat.risk_per_node == per_node, label
        res_n = nat.solve(x0, tol=1e-6, max_iter=30000, algorithm="spock")
        assert res_n["converged"], label
        data, res = _solve(spec, x0, "spock")
        assert float(data.L_sq) == pytest.approx(nat.L_sq, rel=0.05), label
        np.testing.assert_allclose(res_n["u"][0], res.z.u[:, 0].numpy(),
                                   atol=2e-4, err_msg=label)
        np.testing.assert_allclose(res_n["objective"], float(res.z.s[0]),
                                   atol=2e-4, err_msg=label)
    # the last case's tight input bound holds
    assert np.all(np.abs(res_n["u"][:, 1]) <= 0.1 + 1e-6)


def test_native_warm_start_supermann_and_class():
    """A warm solve takes no more iterations than a cold one; SuperMann +
    Anderson fewer than CP, to the same solution; per-node costs raise;
    the heap permutation maps heap node k (parent (k - 1) // d) to the
    port's node perm[k]."""
    spec = car.make_spec(N=3, d=2)
    nat = NativeSolver(spec)
    nat.solve(np.array([0.1, 0.1]), tol=1e-4)
    r2 = nat.solve(np.array([0.11, 0.1]), tol=1e-4)  # warm from r1
    r2_cold = NativeSolver(spec).solve(np.array([0.11, 0.1]), tol=1e-4)
    assert r2["iterations"] <= r2_cold["iterations"]

    spec = server_heat.make_spec(N=4, nx=4, d=2)
    r_cp = NativeSolver(spec).solve(X0_SH, tol=1e-6, max_iter=30000,
                                    algorithm="cp")
    r_sp = NativeSolver(spec).solve(X0_SH, tol=1e-6, max_iter=30000,
                                    algorithm="spock")
    assert r_cp["converged"] and r_sp["converged"]
    assert r_sp["iterations"] < r_cp["iterations"]
    np.testing.assert_allclose(r_sp["u"][0], r_cp["u"][0], atol=3e-4)

    with pytest.raises(NotImplementedError, match="per-node Q"):
        NativeSolver(port_spec(SMALL["pncost"]()))

    t = UniformTree(N=4, d=3)
    perm = _nonleaf_perm(t)
    assert sorted(perm.tolist()) == list(range(t.n_nonleaf))
    for k in range(1, t.n_nonleaf):
        assert t.parent(int(perm[k])) == int(perm[(k - 1) // t.d])


INPUTS = ("A", "B", "sqrtQ", "sqrtR", "sqrtQN", "b", "ker", "Kfac", "Rtinv",
          "ABK", "PB", "x_min", "x_max", "u_min", "u_max", "cone_kinds",
          "cone_dims", "Gx", "Gu", "plo", "phi", "GxN", "ploN", "phiN",
          "L_sq", "risk_per_node", "nz", "nv")


def test_native_matches_jax_native(monkeypatch):
    """The port's NativeSolver and the JAX package's on the same spec, for
    six small problems (uniform, d = 3, polytope rows, per-node risk, both)
    and both algorithms: the inputs they hand the C code are equal, and on
    one library the solves, a cold one and a warm one after it, agree at
    1e-12."""
    for name in ("car", "server_heat", "server_heat_d3", "poly_n4", "navar",
                 "poly_navar"):
        jspec = SMALL[name]()
        for algorithm in ("cp", "spock"):
            got = NativeSolver(port_spec(jspec))
            monkeypatch.setattr(jnative, "_LIB", None)
            ref = jnative.NativeSolver(jspec)
            for attr in INPUTS:
                np.testing.assert_array_equal(
                    getattr(got, attr), getattr(ref, attr),
                    err_msg=f"{name}: {attr}")
            monkeypatch.setattr(jnative, "_LIB", native._lib())
            rng = np.random.default_rng(5)
            for x0 in rng.uniform(-0.4, 0.4, (2, got.nx)):
                a = got.solve(x0, tol=1e-6, max_iter=30000,
                              algorithm=algorithm)
                b = ref.solve(x0, tol=1e-6, max_iter=30000,
                              algorithm=algorithm)
                assert a["converged"] and b["converged"], name
                assert a["iterations"] == b["iterations"], name
                for k in ("x", "u", "s", "tau", "y"):
                    np.testing.assert_allclose(
                        a[k], b[k], rtol=0, atol=1e-12,
                        err_msg=f"{name} {algorithm}: {k}")
