"""Record mode and K0 in the port against the JAX package (float64, CPU).

``record=True`` keeps the per-iteration residual trace: (xi1, xi2) from
``run_cp``, (xi1, xi2, backtracking rounds) from ``run_supermann`` on the
composed and the fused body.  CP is deterministic, so its whole trace is
held; SuperMann trajectories are chaotic, so only its first row is held
against JAX.  K0 (blind updates) is held over one iteration and by its
solution against the port's scipy oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spock_tpu.algorithms import cp as jcp
from spock_tpu.algorithms import supermann as jsp
from spock_tpu.solver import zero_dual as jzero_dual
from spock_tpu.solver import zero_primal as jzero_primal
from spock_tpu_torch.algorithms import cp
from spock_tpu_torch.algorithms import supermann as sp
from spock_tpu_torch.baselines import scipy_ref
from spock_tpu_torch.solver import Solver, zero_dual, zero_primal
from tests.test_torch_supermann import _carry_to_port, _compare_carries
from tests.torch_parity import jax_problem, port_data, port_spec
from tests.torch_parity import release_jax_executables  # noqa: F401

torch.set_num_threads(1)

X0 = np.array([[0.1, 0.1], [-0.4, 0.3]])  # two car lanes
B = X0.shape[0]


@pytest.fixture(scope="module")
def car():
    spec, jdata, jmeta = jax_problem("car")
    pdata, pmeta = port_data(jdata, jmeta)
    return spec, jdata, jmeta, pdata, pmeta


def _jax_start(jmeta):
    return (jnp.asarray(X0), jzero_primal(jmeta, (B,), jnp.float64),
            jzero_dual(jmeta, (B,), jnp.float64))


def _port_start(pmeta):
    return (torch.tensor(X0), zero_primal(pmeta, (B,), torch.float64, "cpu"),
            zero_dual(pmeta, (B,), torch.float64, "cpu"))


def test_cp_trace_matches_jax(car):
    """The whole run_cp trace, [max_iter, B, 2], at 1e-9 relative; the lanes
    converge at different iterations and every lane is written each
    iteration, as in JAX."""
    _, jdata, jmeta, pdata, pmeta = car
    ref = jcp.run_cp(jdata, jmeta, *_jax_start(jmeta), tol=1e-4,
                     max_iter=400, record=True)
    got = cp.run_cp(pdata, pmeta, *_port_start(pmeta), tol=1e-4,
                    max_iter=400, record=True)
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))
    assert got.residuals.shape == (400, B, 2)
    np.testing.assert_allclose(got.residuals.numpy(),
                               np.asarray(ref.residuals), rtol=1e-9,
                               atol=1e-300)


@pytest.mark.parametrize("fused_step", [False, True])
def test_supermann_first_row_matches_jax(car, fused_step):
    """The first recorded SuperMann row (xi1, xi2, rounds) against JAX's
    (on the CPU JAX takes its composed body; the port's fused body there
    runs the step kernels' plain versions), and the trace's shape on each
    body."""
    _, jdata, jmeta, pdata, pmeta = car
    ref = jsp.run_supermann(jdata, jmeta, *_jax_start(jmeta), tol=1e-4,
                            max_iter=1, record=True)
    assert not sp.use_fused_step(pdata, pmeta, sp.SuperMannOpts(),
                                 fused_step=False)
    assert sp.use_fused_step(pdata, pmeta, sp.SuperMannOpts())
    got = sp.run_supermann(pdata, pmeta, *_port_start(pmeta), tol=1e-4,
                           max_iter=1, record=True, fused_step=fused_step)
    assert got.residuals.shape == ((3 if fused_step else 1), B, 3)
    np.testing.assert_allclose(got.residuals[0].numpy(),
                               np.asarray(ref.residuals)[0], rtol=1e-9)


@pytest.mark.parametrize("run", ["cp", "composed", "fused"])
def test_last_row_is_the_final_residual(car, run):
    """test_solver.py's recording test on the port: the trace is positive up
    to each lane's last iteration, whose row is the reported (xi1, xi2);
    the backtracking column holds whole numbers <= max_backtracks."""
    _, _, _, pdata, pmeta = car
    opts = sp.SuperMannOpts()
    if run == "cp":
        res = cp.run_cp(pdata, pmeta, *_port_start(pmeta), tol=1e-4,
                        max_iter=2000, record=True)
    else:
        res = sp.run_supermann(pdata, pmeta, *_port_start(pmeta), tol=1e-4,
                               max_iter=1000, record=True,
                               fused_step=run == "fused")
    assert bool(res.converged.all())
    tr = res.residuals.numpy()
    for lane in range(B):
        n = int(res.iterations[lane])
        assert np.all(tr[:n, lane, :2] > 0)
        np.testing.assert_array_equal(
            tr[n - 1, lane, :2],
            [float(res.xi1[lane]), float(res.xi2[lane])])
    if run != "cp":
        rounds = tr[:, :, 2]
        assert np.all(rounds == np.round(rounds))
        assert np.all((rounds >= 0) & (rounds <= opts.max_backtracks))
        assert np.all(rounds == rounds[:, :1])  # batch-wide


@pytest.mark.parametrize("start", [2, 5])
def test_k0_iteration_matches_jax(start):
    """One K0 iteration (blind updates on), in which a lane takes the blind
    step, from a carry ``start`` K0 iterations into a solve, against JAX's
    at 1e-12.  (Three and four iterations in, the blind steps have made the
    Anderson history rows nearly collinear: the Gram is near-singular, and
    its 1e-10 regularisation turns rounding into errors far above 1e-12 in
    either package, so those carries are not held at 1e-12.)"""
    _, jdata, jmeta = jax_problem("server_heat")
    pdata, pmeta = port_data(jdata, jmeta)
    jopts = jsp.SuperMannOpts(k0=True)
    jbody = jax.jit(jsp.sp_body(jdata, jmeta, jnp.asarray(1e-6), jopts))
    rng = np.random.default_rng(4)
    x0 = jnp.asarray(rng.uniform(-0.5, 0.5, (B, jmeta.nx)))
    jc = jsp.sp_init(jmeta, x0, jzero_primal(jmeta, (B,), jnp.float64),
                     jzero_dual(jmeta, (B,), jnp.float64), jopts)
    for _ in range(start):
        jc = jbody(jc)
    ref = jbody(jc)
    # a lane took the blind step: its threshold eta moved to ||r||
    assert np.any(np.asarray(ref.eta) != np.asarray(jc.eta))
    got = sp.sp_body(pdata, pmeta, 1e-6, sp.SuperMannOpts(k0=True))(
        _carry_to_port(jc))
    _compare_carries(got, ref, atol=1e-12)


def test_k0_solve_matches_oracle(car):
    """test_solver.py's K0 test on the port: a K0 solve converges to the
    oracle's solution."""
    spec, _, _, pdata, pmeta = car
    ora = scipy_ref.solve(port_spec(spec), x0=np.array([0.1, 0.1]))
    res = Solver(pdata, pmeta, algorithm="spock", device="cpu",
                 supermann=sp.SuperMannOpts(k0=True)).solve(
                     np.array([0.1, 0.1]), tol=1e-6)
    assert bool(res.converged)
    assert res.residuals is None
    np.testing.assert_allclose(res.z.u[:, 0].numpy(), ora["u"][0], atol=2e-4)
    np.testing.assert_allclose(float(res.z.s[0]), ora["objective"],
                               atol=2e-4)
