"""The port's MPC drivers: the async farm against the JAX farm, and a farm
lane against a sequence of standalone warm solves within the port (float64,
CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spock_tpu import build as jbuild
from spock_tpu import mpc as jmpc
from spock_tpu.models import server_heat as jsh
from spock_tpu_torch import mpc
from spock_tpu_torch.algorithms import supermann as sp
from spock_tpu_torch.mpc import _plant
from spock_tpu_torch.solver import zero_dual, zero_primal
from tests.torch_parity import port_data
from tests.torch_parity import release_jax_executables  # noqa: F401

torch.set_num_threads(1)

B, T = 3, 4


@pytest.fixture(scope="module")
def problem():
    """server_heat N=4 nx=4 d=2, the size of tests/test_mpc_and_sharding.py."""
    jdata, jmeta = jbuild(jsh.make_spec(N=4, nx=4, d=2), dtype=jnp.float64)
    pdata, pmeta = port_data(jdata, jmeta)
    return jdata, jmeta, pdata, pmeta


def _inputs(seed, nx, d):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.5, 0.5, (B, nx)), rng.integers(0, d, (T, B))


@pytest.mark.parametrize("fused_step", [False, True])
def test_simulate_async_matches_jax(problem, fused_step):
    jdata, jmeta, pdata, pmeta = problem
    x0, ws = _inputs(2, jmeta.nx, jmeta.tree.d)
    ref = jmpc.simulate_async(jdata, jmeta, jnp.asarray(x0), jnp.asarray(ws),
                              tol=1e-4, n_steps=T)
    got = mpc.simulate_async(pdata, pmeta, x0, ws, tol=1e-4, n_steps=T,
                             device="cpu", fused_step=fused_step)
    assert bool((got.steps_done == T).all())
    np.testing.assert_allclose(got.us.numpy(), np.asarray(ref.us), atol=1e-3)
    np.testing.assert_allclose(got.xs.numpy(), np.asarray(ref.xs), atol=5e-3)


@pytest.mark.parametrize("fused_step", [False, True])
def test_farm_lane_equals_standalone_warm_solves(problem, fused_step):
    """Per-solve iteration counts and applied controls of the farm EXACTLY
    equal a sequence of standalone warm-started solves: a refill resets the
    per-solve state, and the Anderson rows of the previous solve drop out by
    the j <= niter rule (newest-first rows, or the fused carry's rows of age
    j, whatever phase slot holds them)."""
    _, _, pdata, pmeta = problem
    x0, ws = _inputs(11, pmeta.nx, pmeta.tree.d)
    tol = 1e-4
    res_a = mpc.simulate_async(pdata, pmeta, x0, ws, tol=tol, n_steps=T,
                               device="cpu", fused_step=fused_step)

    x = torch.tensor(x0)
    z = zero_primal(pmeta, (B,), torch.float64, "cpu")
    v = zero_dual(pmeta, (B,), torch.float64, "cpu")
    iters, us = [], []
    for t in range(T):
        res = sp.run_supermann(pdata, pmeta, x, z, v, tol=tol, max_iter=1000,
                               fused_step=fused_step)
        assert bool(res.converged.all())
        iters.append(res.iterations)
        z, v = res.z, res.v
        u0 = res.z.u[:, :, 0]
        us.append(u0)
        x = _plant(pdata, x, u0, torch.tensor(ws[t]))
    np.testing.assert_array_equal(res_a.iters_per_step.numpy(),
                                  torch.stack(iters).numpy())
    np.testing.assert_array_equal(res_a.us.numpy(), torch.stack(us).numpy())


def test_broyden_farm_lane_equals_standalone_warm_solves(problem):
    """The same with Broyden directions: a refill zeroes the lane's Broyden
    ring, so the farm's iteration counts and controls EXACTLY equal
    standalone warm-started Broyden solves."""
    _, _, pdata, pmeta = problem
    x0, ws = _inputs(13, pmeta.nx, pmeta.tree.d)
    tol = 1e-4
    opts = sp.SuperMannOpts(direction="broyden", broyden_mem=8)
    res_a = mpc.simulate_async(pdata, pmeta, x0, ws, tol=tol, n_steps=T,
                               opts=opts, device="cpu")

    x = torch.tensor(x0)
    z = zero_primal(pmeta, (B,), torch.float64, "cpu")
    v = zero_dual(pmeta, (B,), torch.float64, "cpu")
    iters, us = [], []
    for t in range(T):
        res = sp.run_supermann(pdata, pmeta, x, z, v, tol=tol, max_iter=1000,
                               opts=opts)
        assert bool(res.converged.all())
        iters.append(res.iterations)
        z, v = res.z, res.v
        u0 = res.z.u[:, :, 0]
        us.append(u0)
        x = _plant(pdata, x, u0, torch.tensor(ws[t]))
    np.testing.assert_array_equal(res_a.iters_per_step.numpy(),
                                  torch.stack(iters).numpy())
    np.testing.assert_array_equal(res_a.us.numpy(), torch.stack(us).numpy())


def test_simulate_matches_async(problem):
    """The lockstep simulate and the async farm give the same closed loop."""
    _, _, pdata, pmeta = problem
    x0, ws = _inputs(5, pmeta.nx, pmeta.tree.d)
    res_s = mpc.simulate(pdata, pmeta, x0, ws, tol=1e-4, device="cpu")
    res_a = mpc.simulate_async(pdata, pmeta, x0, ws, tol=1e-4, n_steps=T,
                               device="cpu")
    assert bool((res_s.status == 0).all())
    assert res_s.xs.shape == (T + 1, B, pmeta.nx)
    assert float(res_s.us.abs().max()) <= 1.5 + 1e-9
    np.testing.assert_allclose(res_a.us.numpy(), res_s.us.numpy(), atol=5e-4)
    np.testing.assert_allclose(res_a.xs.numpy(), res_s.xs[-1].numpy(),
                               atol=5e-3)
