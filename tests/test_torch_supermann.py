"""The port's sweeps, Anderson direction and one SuperMann iteration
against the JAX package (float64, CPU).

SuperMann trajectories are chaotic (discrete K1/K2/backtracking decisions
amplify reduction-order noise), so the iterate is compared for one
iteration only; test_torch_solver.py compares whole solves by their
solutions."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spock_tpu.algorithms import anderson as janderson
from spock_tpu.algorithms import broyden as jbroyden
from spock_tpu.algorithms import common as jcommon
from spock_tpu.algorithms import supermann as jsp
from spock_tpu.solver import Solver as JSolver
from spock_tpu.solver import zero_dual as jzero_dual
from spock_tpu.solver import zero_primal as jzero_primal
from spock_tpu_torch.algorithms import anderson, broyden, common
from spock_tpu_torch.algorithms import supermann as sp
from spock_tpu_torch.solver import Solver
from tests.torch_parity import (
    assert_close, jax_problem, port_data, rand_pair, to_jax, to_port)

torch.set_num_threads(1)

GAMMA, SIGMA = 0.21, 0.37
B = 4
SP_TOL = 1e-6


@pytest.fixture(scope="module")
def problem():
    _, jdata, jmeta = jax_problem("server_heat")
    pdata, pmeta = port_data(jdata, jmeta)
    return jdata, jmeta, pdata, pmeta


@pytest.fixture(scope="module")
def jax_body(problem):
    jdata, jmeta, _, _ = problem
    return jax.jit(jsp.sp_body(jdata, jmeta, jnp.asarray(SP_TOL)))


def test_cp_sweep_metric_matches_jax(problem):
    jdata, jmeta, pdata, pmeta = problem
    rng = np.random.default_rng(0)
    z, v = rand_pair(rng, jmeta, batch=(B,))
    x0 = rng.standard_normal((B, jmeta.nx))
    ref = jax.jit(jcommon.cp_sweep_metric_ref, static_argnums=1)(
        jdata, jmeta, to_jax(z), to_jax(v), GAMMA, SIGMA, jnp.asarray(x0))
    got = common.cp_sweep_metric(pdata, pmeta, to_port(z), to_port(v), GAMMA,
                                 SIGMA, to_port(x0))
    assert_close(got, ref, atol=1e-12)


def test_candidate_sweep_matches_jax(problem):
    jdata, jmeta, pdata, pmeta = problem
    rng = np.random.default_rng(1)
    z, v = rand_pair(rng, jmeta, batch=(B,))
    dz, dv = rand_pair(rng, jmeta, batch=(B,))
    x0 = rng.standard_normal((B, jmeta.nx))
    tau = rng.random(B)
    ref = jax.jit(jcommon.candidate_sweep_ref, static_argnums=1)(
        jdata, jmeta, to_jax(z), to_jax(v), to_jax(dz), to_jax(dv),
        jnp.asarray(tau), GAMMA, SIGMA, jnp.asarray(x0))
    got = common.candidate_sweep(
        pdata, pmeta, to_port(z), to_port(v), to_port(dz), to_port(dv),
        to_port(tau), GAMMA, SIGMA, to_port(x0))
    assert_close(got, ref, atol=1e-12)


def test_solve3_matches_jax():
    rng = np.random.default_rng(2)
    M = rng.standard_normal((5, 3, 3))
    A = M @ np.swapaxes(M, -1, -2) + 0.1 * np.eye(3)
    b = rng.standard_normal((5, 3))
    got = anderson._solve3(torch.tensor(A), torch.tensor(b))
    ref = janderson._solve3(jnp.asarray(A), jnp.asarray(b))
    assert_close(got, ref, atol=1e-12)
    np.testing.assert_allclose(
        got.numpy(), np.linalg.solve(A, b[..., None])[..., 0], atol=1e-10)


def test_solve3_survives_a_small_float32_gram():
    """The regularised Gram of a lane's first iteration near convergence:
    one valid row of squared norm 1e-7, the others masked to the 1e-10
    regularisation.  The adjugate's float32 determinant (~1e-42) is below
    the normal range, so an unscaled solve overflows 1 / det and returns inf
    or NaN weights; the scaled solve matches the float64 one."""
    g00 = 1e-7
    eps = 1e-10 * (g00 / 3) + 1e-30
    A = np.diag([g00 + eps, eps, eps])[None]
    b = np.array([[g00, 0.0, 0.0]])
    ref = np.linalg.solve(A, b[..., None])[..., 0]
    got = anderson._solve3(torch.tensor(A, dtype=torch.float32),
                           torch.tensor(b, dtype=torch.float32))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-12)


def test_direction_struct_matches_jax(problem):
    """Newest-first histories with a mix of lane ages (stale rows masked)."""
    _, jmeta, _, _ = problem
    rng = np.random.default_rng(3)
    MR = rand_pair(rng, jmeta, batch=(B, 3))
    MP = rand_pair(rng, jmeta, batch=(B, 3))
    r = rand_pair(rng, jmeta, batch=(B,))
    niter = np.array([0, 1, 2, 7], np.int32)
    ref = janderson.direction_struct(to_jax(MR), to_jax(MP), to_jax(r),
                                     jnp.asarray(niter))
    got = anderson.direction_struct(to_port(MR), to_port(MP), to_port(r),
                                    to_port(niter))
    assert_close(got, ref, atol=1e-12)
    new = rand_pair(rng, jmeta, batch=(B,))
    assert_close(anderson.hist_insert(to_port(MR), to_port(new)),
                 janderson.hist_insert(to_jax(MR), to_jax(new)), atol=0.0)


def _random_carry(rng, jmeta, cache_valid):
    """A JAX SPCarry with numpy-made values: lanes of different ages, one
    lane done, random histories."""
    zpair = lambda batch=(B,): rand_pair(rng, jmeta, batch=batch)  # noqa: E731
    z, v = zpair()
    zbar_c, vbar_c = zpair()
    c = jsp.SPCarry(
        x0=0.5 * rng.standard_normal((B, jmeta.nx)),
        z=z, v=v, r_prev=zpair(), s_prev=zpair(),
        dirstate=(zpair((B, 3)), zpair((B, 3))),
        r_safe=np.array([np.inf, 50.0, 1e3, 5.0]),
        eta=np.full(B, np.inf),
        res0=np.array([[-np.inf, -np.inf], [2.0, 3.0], [1.0, 4.0],
                       [0.5, 0.5]]),
        done=np.array([False, False, False, True]),
        niter=np.array([0, 1, 2, 6], np.int32),
        xi1=np.full(B, np.inf), xi2=np.full(B, np.inf),
        it=np.int32(4), hist=np.zeros((0, B, 3)),
        cache_valid=np.full(B, cache_valid),
        zbar_c=zbar_c, vbar_c=vbar_c,
        rnorm_c=rng.random(B) + 1.0, nMrz_c=rng.random(B),
        nMrv_c=rng.random(B),
    )
    return jax.tree_util.tree_map(jnp.asarray, c)


def _carry_to_port(jc):
    fields = {}
    for fl in dataclasses.fields(sp.SPCarry):
        val = getattr(jc, fl.name)
        fields[fl.name] = int(val) if fl.name == "it" else to_port(
            jax.tree_util.tree_map(np.asarray, val))
    return sp.SPCarry(**fields)


def _compare_carries(got, ref, atol):
    for fl in dataclasses.fields(sp.SPCarry):
        if fl.name == "it":
            assert got.it == int(ref.it)
            continue
        assert_close(getattr(got, fl.name), getattr(ref, fl.name), atol=atol,
                     path=fl.name)


@pytest.mark.parametrize("start", ["random", "random_cached", "solve"])
def test_one_sp_body_iteration_matches_jax(problem, jax_body, start):
    """One SuperMann iteration from the same carry, at 1e-10."""
    _, jmeta, pdata, pmeta = problem
    jbody = jax_body
    rng = np.random.default_rng(4)
    if start == "solve":
        x0 = jnp.asarray(rng.uniform(-0.5, 0.5, (B, jmeta.nx)))
        jc = jsp.sp_init(jmeta, x0, jzero_primal(jmeta, (B,), jnp.float64),
                         jzero_dual(jmeta, (B,), jnp.float64))
        for _ in range(3):
            jc = jbody(jc)
    else:
        jc = _random_carry(rng, jmeta, cache_valid=start == "random_cached")
    pc = _carry_to_port(jc)
    ref = jbody(jc)
    got = sp.sp_body(pdata, pmeta, SP_TOL)(pc)
    _compare_carries(got, ref, atol=1e-10)


def test_broyden_direction_matches_jax():
    """One restarted-Broyden direction and ring update, lanes at every
    history length (0, partial, full: the full lane restarts)."""
    rng = np.random.default_rng(5)
    Bn, K, max_k = 4, 37, 5
    state = jbroyden.BroydenState(
        S=rng.standard_normal((Bn, max_k, K)),
        St=rng.standard_normal((Bn, max_k, K)),
        Ps=rng.standard_normal((Bn, max_k, K)),
        k=np.array([0, 2, 5, 3], np.int32))
    r, s_, y, ps = (rng.standard_normal((Bn, K)) for _ in range(4))
    ref = jbroyden.direction(to_jax(state), *map(jnp.asarray, (r, s_, y, ps)),
                             max_k)
    got = broyden.direction(
        broyden.BroydenState(**{k: to_port(getattr(state, k))
                                for k in ("S", "St", "Ps", "k")}),
        *map(to_port, (r, s_, y, ps)), max_k)
    assert_close(got[0], ref[0], atol=1e-12)
    for k in ("S", "St", "Ps", "k"):
        assert_close(getattr(got[1], k), getattr(ref[1], k), atol=1e-12,
                     path=k)


def test_broyden_solve_matches_jax():
    """Car N=3 with Broyden directions: the root controls and the objective
    of the two packages' solves agree (tests/test_solver.py:135)."""
    _, jdata, jmeta = jax_problem("car")
    pdata, pmeta = port_data(jdata, jmeta)
    x0 = np.array([0.1, 0.1])
    ref = JSolver(jdata, jmeta, supermann=jsp.SuperMannOpts(
        direction="broyden", broyden_mem=10)).solve(x0, tol=1e-6)
    got = Solver(pdata, pmeta, supermann=sp.SuperMannOpts(
        direction="broyden", broyden_mem=10), device="cpu").solve(
        x0, tol=1e-6)
    assert bool(got.converged) and bool(ref.converged)
    np.testing.assert_allclose(got.z.u[:, 0].numpy(),
                               np.asarray(ref.z.u)[:, 0], atol=2e-4)
    np.testing.assert_allclose(float(got.z.s[0]), float(ref.z.s[0]),
                               atol=2e-4)
