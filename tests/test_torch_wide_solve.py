"""Port solves and the port's farm on the wider problem class (two-sided
polytope rows, per-node risk, per-node costs) against the JAX Solver and
against standalone warm solves, float64 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spock_tpu import build as jbuild
from spock_tpu.solver import Solver as JSolver
from spock_tpu_torch import mpc
from spock_tpu_torch.algorithms import supermann as sp
from spock_tpu_torch.mpc import _plant
from spock_tpu_torch.solver import Solver, zero_dual, zero_primal
from tests.torch_parity import SMALL, port_data
from tests.torch_parity import release_jax_executables  # noqa: F401

torch.set_num_threads(1)

B = 2


@pytest.mark.parametrize("name", ["poly", "navar", "pncost"])
def test_solve_matches_jax_solver(name):
    """Port solves (the fused step where it covers the class, the fused
    sweep on per-node costs) have the JAX Solver's solution at tol 1e-6:
    root controls and objective within 3e-4."""
    jdata, jmeta = jbuild(SMALL[name](), dtype=jnp.float64)
    pdata, pmeta = port_data(jdata, jmeta)
    assert sp.use_fused_step(pdata, pmeta, sp.SuperMannOpts()) == (
        name != "pncost")
    x0 = np.random.default_rng(3).uniform(-0.5, 0.5, (2, jmeta.nx))
    ref = JSolver(jdata, jmeta).solve(jnp.asarray(x0), tol=1e-6)
    got = Solver(pdata, pmeta, device="cpu").solve(x0, tol=1e-6)
    assert bool(got.converged.all()) and bool(np.asarray(ref.converged).all())
    np.testing.assert_allclose(got.z.u[:, :, 0].numpy(),
                               np.asarray(ref.z.u)[:, :, 0], atol=3e-4)
    np.testing.assert_allclose(got.z.s[:, 0].numpy(),
                               np.asarray(ref.z.s[:, 0]), atol=3e-4)


def test_polytope_farm_lane_equals_standalone_warm_solves():
    """On the polytope problem, per-solve iteration counts and applied
    controls of the fused-step farm EXACTLY equal a sequence of standalone
    warm-started solves: the polytope blocks are refilled and warm-started
    like the others."""
    jdata, jmeta = jbuild(SMALL["poly"](), dtype=jnp.float64)
    pdata, pmeta = port_data(jdata, jmeta)
    T = 3
    rng = np.random.default_rng(11)
    x0 = rng.uniform(-0.5, 0.5, (B, pmeta.nx))
    ws = rng.integers(0, pmeta.tree.d, (T, B))
    tol = 1e-4
    res_a = mpc.simulate_async(pdata, pmeta, x0, ws, tol=tol, n_steps=T,
                               device="cpu")
    assert res_a.v.pnl is not None and res_a.v.plf is not None
    x = torch.tensor(x0)
    z = zero_primal(pmeta, (B,), torch.float64, "cpu")
    v = zero_dual(pmeta, (B,), torch.float64, "cpu")
    iters, us = [], []
    for t in range(T):
        res = sp.run_supermann(pdata, pmeta, x, z, v, tol=tol, max_iter=1000)
        assert bool(res.converged.all())
        iters.append(res.iterations)
        z, v = res.z, res.v
        us.append(res.z.u[:, :, 0])
        x = _plant(pdata, x, us[-1], torch.tensor(ws[t]))
    np.testing.assert_array_equal(res_a.iters_per_step.numpy(),
                                  torch.stack(iters).numpy())
    np.testing.assert_array_equal(res_a.us.numpy(), torch.stack(us).numpy())
