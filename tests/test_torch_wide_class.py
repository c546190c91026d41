"""The JAX kernels' whole problem class on the port's kernels: problems with
nx above 32 or an S2 projector of more than 32 values (ny + 2 d, d >= 8
under AV@R), which the port's step kernels now take on their element
instance.  The port's plain step and sweeps (the wrappers' CPU route)
against the JAX package's Pallas kernels in interpret mode, its class
against theirs, and a cold fused-step solve against the JAX Solver, float64
on the CPU.  The CUDA kernels themselves are held against the plain
versions on the card (tests/test_torch_isolation.py, chip_smoke.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spock_tpu import build as jbuild
from spock_tpu import problem as jproblem
from spock_tpu.models import server_heat as jsh
from spock_tpu.ops import pallas_spstep, pallas_spstep_lt, pallas_sweep
from spock_tpu.solver import Solver as JSolver
from spock_tpu_torch.algorithms import supermann as sp
from spock_tpu_torch.ops import spstep, sweep_kernels
from spock_tpu_torch.solver import Solver
from tests.torch_parity import (
    assert_close, port_data, rand_pair, to_jax, to_port)
from tests.torch_parity import release_jax_executables  # noqa: F401

torch.set_num_threads(1)

B = 2
GAMMA, SIGMA = 0.3, 0.25
KNOBS = dict(c1=0.99, sigma_k2=0.1, lam=1.0, lam_sp=1.0)
RTOL, ATOL = 1e-9, 1e-10
# tests/test_torch_spstep.py's packs (active, valid1, valid2, cache, r_safe,
# q_pow, rnorm_c, nMrz_c, nMrv_c, tau), one row per lane
PACKS = {
    "warm": [[1, 1, 1, 0, 1e3, 0.9, 0, 0, 0, 1.0],
             [0, 1, 1, 1, 5.0, 0.8, 3.0, 0.5, 0.7, 1.0]],
    "retrial": [[1, 1, 1, 0, 40.0, 0.9, 0, 0, 0, 0.5],
                [1, 1, 1, 0, 1e3, 0.8, 0, 0, 0, 0.25]],
}
# (N, nx, d): nx above 32, and ny + 2 d = 33 (d = 8 under AV@R)
SHAPES = {"nx33": (2, 33, 2), "d8": (2, 2, 8)}


def _problem(N, nx, d):
    jdata, jmeta = jbuild(jsh.make_spec(N=N, nx=nx, d=d), dtype=jnp.float64)
    pdata, pmeta = port_data(jdata, jmeta)
    return jdata, jmeta, pdata, pmeta


@pytest.mark.parametrize("shape", list(SHAPES))
def test_step_matches_jax_kernels(shape):
    """sp_step_fused (the port's plain step on the CPU) against
    pallas_spstep.sp_step_fused at packs "warm" and "retrial" and against
    pallas_spstep_lt.sp_step_fused at "warm" (tau = 1): the six output
    pairs and output slots 0-12 within rtol 1e-9 / atol 1e-10, the K1 / K2 /
    loop decisions exactly equal.  Both JAX kernels take the problem, and
    the port's element instance does."""
    jdata, jmeta, pdata, pmeta = _problem(*SHAPES[shape])
    assert pallas_spstep.supported(jmeta, jdata)
    assert spstep.step_body(pmeta, pdata, torch.float64) == "element"
    rng = np.random.default_rng(17)
    pairs = [rand_pair(rng, jmeta, batch=(B,)) for _ in range(8)]
    x0 = rng.uniform(-0.5, 0.5, (B, jmeta.nx))
    (z, v), *rest = [to_port(q) for q in pairs]
    for pack, kernel in (("warm", pallas_spstep), ("retrial", pallas_spstep),
                         ("warm", pallas_spstep_lt)):
        scal = np.array(PACKS[pack])
        before = dict(spstep.LAUNCHES)
        got = spstep.sp_step_fused(pdata, pmeta, z, v, *rest, to_port(x0),
                                   torch.tensor(scal), GAMMA, SIGMA, **KNOBS)
        assert spstep.LAUNCHES == before  # CPU tensors: no launch
        if kernel is pallas_spstep_lt:
            scal = scal[:, :spstep.SC_TAU]
        trios = [kernel.pack_pair(jmeta, *to_jax(q)) for q in pairs]
        ref = kernel.sp_step_fused(jdata, jmeta, *trios, jnp.asarray(x0),
                                   jnp.asarray(scal), GAMMA, SIGMA, **KNOBS,
                                   interpret=True)
        for i, g in enumerate(got[:6]):
            assert_close(g, kernel.unpack_pair(jmeta, ref[i]), atol=ATOL,
                         rtol=RTOL, path=f"{pack} pair {i}")
        sc, ref_sc = got[6].numpy(), np.asarray(ref[6])
        np.testing.assert_array_equal(sc[:, :3], ref_sc[:, :3])
        np.testing.assert_allclose(sc[:, :13], ref_sc[:, :13], rtol=RTOL,
                                   atol=ATOL)


def test_sweeps_match_jax_kernels_above_32_projector_values():
    """cp_sweep_metric_fused and candidate_sweep_fused at d = 8 (ny + 2 d =
    33) against pallas_sweep's in interpret mode, within
    tests/test_pallas_sweep.py's 1e-10."""
    jdata, jmeta, pdata, pmeta = _problem(*SHAPES["d8"])
    assert pallas_sweep.supported(jmeta, jdata)
    assert sweep_kernels.sweep_body(pmeta, pdata, torch.float64) == "element"
    rng = np.random.default_rng(7)
    z, v = rand_pair(rng, jmeta, batch=(B,))
    dz, dv = rand_pair(rng, jmeta, batch=(B,))
    x0 = rng.standard_normal((B, jmeta.nx))
    tau = rng.random(B)
    ref = pallas_sweep.cp_sweep_metric_fused(
        jdata, jmeta, to_jax(z), to_jax(v), GAMMA, SIGMA, jnp.asarray(x0),
        interpret=True)
    got = sweep_kernels.cp_sweep_metric_fused(
        pdata, pmeta, to_port(z), to_port(v), GAMMA, SIGMA, to_port(x0))
    assert_close(got, ref, atol=ATOL)
    ref = pallas_sweep.candidate_sweep_fused(
        jdata, jmeta, to_jax(z), to_jax(v), to_jax(dz), to_jax(dv),
        jnp.asarray(tau), GAMMA, SIGMA, jnp.asarray(x0), interpret=True)
    got = sweep_kernels.candidate_sweep_fused(
        pdata, pmeta, to_port(z), to_port(v), to_port(dz), to_port(dv),
        to_port(tau), GAMMA, SIGMA, to_port(x0))
    assert_close(got, ref, atol=ATOL)


def _poly_rows(spec, rows):
    """``rows`` two-sided polytope rows at every node (seed 5), a band
    that the origin satisfies."""
    rng = np.random.default_rng(5)
    nx = spec.dynamics.A.shape[-1]
    nu = spec.dynamics.B.shape[-1]
    return dataclasses.replace(spec, polytope=jproblem.Polytope(
        Gx=rng.standard_normal((rows, nx)), Gu=rng.standard_normal((rows, nu)),
        lo=-np.ones(rows), hi=np.ones(rows),
        GxN=rng.standard_normal((rows, nx)), loN=-np.ones(rows),
        hiN=np.ones(rows)))


def test_jax_class_implies_port_class():
    """Where a JAX step or sweep kernel takes a problem, the port's
    counterpart does: nx = 33 and nx = 50 at N = 3, ny + 2 d = 33 and 41
    (d = 8 and 10 under AV@R), and 33 polytope rows a node.  Each of these
    is above the node body's 32, so the port runs it on the element
    bodies."""
    specs = {"nx33": jsh.make_spec(N=3, nx=33, d=2),
             "nx50": jsh.make_spec(N=3, nx=50, d=2),
             "d8": jsh.make_spec(N=3, nx=4, d=8),
             "d10": jsh.make_spec(N=2, nx=4, d=10),
             "poly33": _poly_rows(jsh.make_spec(N=3, nx=3, d=2), 33)}
    for name, spec in specs.items():
        jdata, jmeta = jbuild(spec, dtype=jnp.float64)
        pdata, pmeta = port_data(jdata, jmeta)
        assert pallas_sweep.supported(jmeta, jdata), name
        assert sweep_kernels.supported(pmeta, pdata), name
        assert sweep_kernels.sweep_body(pmeta, pdata,
                                        torch.float32) == "element", name
        if pallas_spstep.supported(jmeta, jdata):
            assert spstep.supported(pmeta, pdata), name
            assert sp.use_fused_step(pdata, pmeta, sp.SuperMannOpts()), name


def test_cold_fused_step_solve_matches_jax_solver():
    """A cold Solver at nx = nu = 33, N = 3 takes the fused step (the step
    kernels' element instance on the card, their plain version here) and
    reaches the JAX Solver's solution: both at tol 1e-8 in float64, root
    controls within 1e-5.  Solutions are compared, never the SuperMann
    iterates, which differ in the last bits from the first iteration on."""
    jdata, jmeta = jbuild(jsh.make_spec(N=3, nx=33, d=2), dtype=jnp.float64)
    pdata, pmeta = port_data(jdata, jmeta)
    assert sp.use_fused_step(pdata, pmeta, sp.SuperMannOpts())
    x0 = np.random.default_rng(3).uniform(-0.5, 0.5, (B, jmeta.nx))
    ref = JSolver(jdata, jmeta).solve(jnp.asarray(x0), tol=1e-8)
    got = Solver(pdata, pmeta, device="cpu").solve(x0, tol=1e-8)
    assert bool(got.converged.all()) and bool(np.asarray(ref.converged).all())
    np.testing.assert_allclose(got.z.u[:, :, 0].numpy(),
                               np.asarray(ref.z.u)[:, :, 0], atol=1e-5)
