"""Whole solves of the port against the JAX solver on the car problem
(float64, CPU): the solutions agree, as tests/test_solver.py holds the JAX
solver against its oracle."""

import numpy as np
import pytest
import torch

from spock_tpu.solver import Solver as JSolver
from spock_tpu_torch.solver import Solver
from tests.torch_parity import jax_problem, port_data

torch.set_num_threads(1)


@pytest.mark.parametrize("algorithm", ["spock", "cp"])
def test_solver_matches_jax_solver(algorithm):
    """Car N=3: root controls and objective of the two solvers agree."""
    _, jdata, jmeta = jax_problem("car")
    pdata, pmeta = port_data(jdata, jmeta)
    x0 = np.array([0.1, 0.1])
    ref = JSolver(jdata, jmeta, algorithm=algorithm).solve(x0, tol=1e-6)
    got = Solver(pdata, pmeta, algorithm=algorithm, device="cpu").solve(
        x0, tol=1e-6)
    assert bool(got.converged) and bool(ref.converged)
    np.testing.assert_allclose(got.z.u[:, 0].numpy(),
                               np.asarray(ref.z.u)[:, 0], atol=2e-4)
    np.testing.assert_allclose(float(got.z.s[0]), float(ref.z.s[0]),
                               atol=2e-4)


@pytest.mark.parametrize("algorithm", ["spock", "cp"])
def test_composed_path_solves_as_the_fused_path(algorithm):
    """fused_sweep=False takes the composed sweep; on the CPU both routes run
    the same plain operators, so the solves agree exactly (both on sp_body:
    the fused step is held in tests/test_torch_spstep.py)."""
    _, jdata, jmeta = jax_problem("car")
    pdata, pmeta = port_data(jdata, jmeta)
    x0 = np.array([0.1, 0.1])
    fused = Solver(pdata, pmeta, algorithm=algorithm, device="cpu",
                   fused_step=False).solve(x0, tol=1e-6)
    composed = Solver(pdata, pmeta, algorithm=algorithm, device="cpu",
                      fused_sweep=False, fused_step=False).solve(x0, tol=1e-6)
    assert int(fused.iterations) == int(composed.iterations)
    np.testing.assert_array_equal(fused.z.u.numpy(), composed.z.u.numpy())
