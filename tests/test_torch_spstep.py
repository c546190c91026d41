"""The port's fused SuperMann step (ops/spstep.py, algorithms/supermann.py's
fused carry) against the JAX package's fused-step Pallas kernels
(spock_tpu/ops/pallas_spstep.py and pallas_spstep_lt.py, interpret mode),
and the port's fused step against its own composed SuperMann iteration,
float64 on the CPU, where the wrapper takes its plain version.  The CUDA
kernel itself is held against the plain version on the card
(tests/test_torch_isolation.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spock_tpu import build as jbuild
from spock_tpu.models import server_heat as jsh
from spock_tpu.ops import pallas_spstep, pallas_spstep_lt
from spock_tpu.solver import Solver as JSolver
from spock_tpu_torch.algorithms import supermann as sp
from spock_tpu_torch.ops import spstep
from spock_tpu_torch.solver import Solver, zero_dual, zero_primal
from tests.torch_parity import (
    assert_close, jax_problem, port_data, rand_pair, to_jax, to_port)

torch.set_num_threads(1)

B = 2
GAMMA, SIGMA = 0.3, 0.25
KNOBS = dict(c1=0.99, sigma_k2=0.1, lam=1.0, lam_sp=1.0)
INF = np.inf
# scalar packs, one row per lane: active, valid1, valid2, cache, r_safe,
# q_pow, rnorm_c, nMrz_c, nMrv_c, tau
PACKS = {
    "cold": [[1, 0, 0, 0, INF, 1.0, 0, 0, 0, 1.0],
             [1, 0, 0, 0, INF, 1.0, 0, 0, 0, 1.0]],
    "warm": [[1, 1, 1, 0, 1e3, 0.9, 0, 0, 0, 1.0],
             [0, 1, 1, 1, 5.0, 0.8, 3.0, 0.5, 0.7, 1.0]],
    "cached_active": [[1, 1, 0, 1, 1e3, 0.9, 1e3, 0.5, 0.7, 1.0],
                      [1, 1, 1, 0, 2.0, 0.7, 0, 0, 0, 1.0]],
    "retrial": [[1, 1, 1, 0, 40.0, 0.9, 0, 0, 0, 0.5],
                [1, 1, 1, 0, 1e3, 0.8, 0, 0, 0, 0.25]],
    # lane 0 neither K1 (r_safe) nor K2 (tau = 2): the CP fallback
    "fallback": [[1, 1, 1, 0, 1.0, 0.9, 0, 0, 0, 2.0],
                 [1, 1, 0, 0, 1.0, 0.8, 0, 0, 0, 0.5]],
}
RTOL, ATOL = 1e-9, 1e-10


@pytest.fixture(scope="module")
def problem():
    """server_heat N=3 nx=4 d=2."""
    jdata, jmeta = jbuild(jsh.make_spec(N=3, nx=4, d=2), dtype=jnp.float64)
    pdata, pmeta = port_data(jdata, jmeta)
    assert pallas_spstep.supported(jmeta, jdata)
    assert spstep.supported(pmeta, pdata)
    return jdata, jmeta, pdata, pmeta


@pytest.fixture(scope="module")
def step_inputs(problem):
    """The eight pairs (z, cache, r_prev, s_prev, MR age 1 and 2, MP age 1
    and 2) and x0, made with numpy."""
    _, jmeta, _, _ = problem
    rng = np.random.default_rng(17)
    pairs = [rand_pair(rng, jmeta, batch=(B,)) for _ in range(8)]
    x0 = rng.uniform(-0.5, 0.5, (B, jmeta.nx))
    return pairs, x0


def _port_step(problem, step_inputs, scal):
    _, _, pdata, pmeta = problem
    pairs, x0 = step_inputs
    (z, v), *rest = [to_port(q) for q in pairs]
    before = dict(spstep.LAUNCHES)
    out = spstep.sp_step_fused(pdata, pmeta, z, v, *rest, to_port(x0),
                               torch.tensor(scal, dtype=torch.float64), GAMMA,
                               SIGMA, **KNOBS)
    assert spstep.LAUNCHES == before  # CPU tensors: no launch
    return out


def _compare(got, ref_pairs, ref_scal):
    for i, (g, r) in enumerate(zip(got[:6], ref_pairs)):
        assert_close(g, r, atol=ATOL, rtol=RTOL, path=f"pair {i}")
    sc, ref_scal = got[6].numpy(), np.asarray(ref_scal)
    # the K1 / K2 / loop decisions agree exactly
    np.testing.assert_array_equal(sc[:, :3], ref_scal[:, :3])
    np.testing.assert_allclose(sc[:, :13], ref_scal[:, :13], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("pack", list(PACKS))
def test_step_matches_jax_kernel(problem, step_inputs, pack):
    """One step against pallas_spstep.sp_step_fused at any tau: the six
    output pairs and output slots 0-12."""
    jdata, jmeta, _, _ = problem
    pairs, x0 = step_inputs
    scal = np.array(PACKS[pack])
    trios = [pallas_spstep.pack_pair(jmeta, *to_jax(q)) for q in pairs]
    ref = pallas_spstep.sp_step_fused(
        jdata, jmeta, *trios, jnp.asarray(x0), jnp.asarray(scal), GAMMA,
        SIGMA, **KNOBS, interpret=True)
    ref_pairs = [pallas_spstep.unpack_pair(jmeta, t) for t in ref[:6]]
    _compare(_port_step(problem, step_inputs, scal), ref_pairs, ref[6])


@pytest.mark.parametrize("pack", ["cold", "warm", "cached_active"])
def test_step_matches_lane_tiled_jax_kernel(problem, step_inputs, pack):
    """The same at tau = 1 against pallas_spstep_lt.sp_step_fused, whose
    scalar pack has no tau slot."""
    jdata, jmeta, _, _ = problem
    pairs, x0 = step_inputs
    scal = np.array(PACKS[pack])
    assert (scal[:, spstep.SC_TAU] == 1.0).all()
    trios = [pallas_spstep_lt.pack_pair(jmeta, *to_jax(q)) for q in pairs]
    ref = pallas_spstep_lt.sp_step_fused(
        jdata, jmeta, *trios, jnp.asarray(x0),
        jnp.asarray(scal[:, :spstep.SC_TAU]), GAMMA, SIGMA, **KNOBS,
        interpret=True)
    ref_pairs = [pallas_spstep_lt.unpack_pair(jmeta, t) for t in ref[:6]]
    _compare(_port_step(problem, step_inputs, scal), ref_pairs, ref[6])


def _iterate(pdata, pmeta, x0, opts, n_it, fused):
    B_ = x0.shape[0]
    z0 = zero_primal(pmeta, (B_,), torch.float64, "cpu")
    v0 = zero_dual(pmeta, (B_,), torch.float64, "cpu")
    tol = 1e-12  # never reached: every lane stays active
    if fused:
        c = sp.sp_init_fused(pmeta, x0, z0, v0, opts)
        bodies = [sp.sp_body_fused(pdata, pmeta, tol, opts, phase=ph)
                  for ph in range(3)]
        for k in range(n_it):
            c = bodies[k % 3](c)
    else:
        c = sp.sp_init(pmeta, x0, z0, v0, opts)
        body = sp.sp_body(pdata, pmeta, tol, opts)
        for _ in range(n_it):
            c = body(c)
    return c


def _compare_iterates(cf, c):
    for name in ("z", "v"):
        got, ref = getattr(cf, name), getattr(c, name)
        for fl in got.__dataclass_fields__:
            a, b = getattr(got, fl), getattr(ref, fl)
            if b is None:
                assert a is None
                continue
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{name}.{fl}")
    np.testing.assert_allclose(cf.r_safe.numpy(), c.r_safe.numpy(),
                               rtol=RTOL)
    np.testing.assert_allclose(cf.xi1.numpy(), c.xi1.numpy(), rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_array_equal(cf.niter.numpy(), c.niter.numpy())


@pytest.fixture(scope="module")
def server_heat_n4():
    """server_heat N=4 nx=4 d=2 (tests/test_fused_step.py's size)."""
    jdata, jmeta = jbuild(jsh.make_spec(N=4, nx=4, d=2), dtype=jnp.float64)
    return port_data(jdata, jmeta)


@pytest.mark.parametrize("n_it", [1, 2, 6])
def test_fused_iterations_match_composed_body(server_heat_n4, n_it):
    """From the same state the fused step and the composed sp_body are the
    same algorithm: the iterates agree to float64 reduction-order noise over
    the K2/fallback (cold) and K1-cached (warm) regimes."""
    pdata, pmeta = server_heat_n4
    rng = np.random.default_rng(3)
    x0 = torch.tensor(rng.uniform(-0.5, 0.5, (4, pmeta.nx)))
    opts = sp.SuperMannOpts()
    assert sp.use_fused_step(pdata, pmeta, opts)
    cf = _iterate(pdata, pmeta, x0, opts, n_it, fused=True)
    c = _iterate(pdata, pmeta, x0, opts, n_it, fused=False)
    assert cf.it == c.it == n_it
    _compare_iterates(cf, c)


def test_retrial_path_matches_composed_backtracking(monkeypatch):
    """Backtracking by relaunching the step at the shrunken per-lane tau
    against sp_body's geometric backtracking, on car N=3 with acceptance
    rigged so every lane backtracks to the CP fallback: c1 ~ 0 kills K1 and
    sigma_k2 huge kills K2."""
    _, jdata, jmeta = jax_problem("car")
    pdata, pmeta = port_data(jdata, jmeta)
    rng = np.random.default_rng(23)
    x0 = torch.tensor(rng.uniform(-0.3, 0.3, (2, pmeta.nx)))
    opts = sp.SuperMannOpts(c1=1e-9, sigma_k2=1e9, max_backtracks=3)
    calls = []
    plain = spstep.sp_step_ref

    def counted(*args, **kwargs):
        calls.append(args[12][:, spstep.SC_TAU].tolist())
        return plain(*args, **kwargs)

    monkeypatch.setattr(spstep, "sp_step_ref", counted)
    n_it = 2
    cf = _iterate(pdata, pmeta, x0, opts, n_it, fused=True)
    # each iteration: the tau = 1 launch, then retrials at 0.5, 0.25, 0.125
    assert [t[0] for t in calls] == [1.0, 0.5, 0.25, 0.125] * n_it
    c = _iterate(pdata, pmeta, x0, opts, n_it, fused=False)
    _compare_iterates(cf, c)


def test_fused_solve_matches_jax_solver(problem):
    """A fused-step solve has the JAX solver's solution (controls and
    objective within 1e-4), and takes the iterations of the port's composed
    solve within 5% + 3 (float64 sums in another order flip a few K1
    decisions)."""
    jdata, jmeta, pdata, pmeta = problem
    rng = np.random.default_rng(3)
    x0 = rng.uniform(-0.5, 0.5, (3, jmeta.nx))
    ref = JSolver(jdata, jmeta).solve(jnp.asarray(x0), tol=1e-5)
    got = Solver(pdata, pmeta, device="cpu").solve(x0, tol=1e-5)
    composed = Solver(pdata, pmeta, device="cpu", fused_step=False).solve(
        x0, tol=1e-5)
    assert bool(got.converged.all()) and bool(np.asarray(ref.converged).all())
    np.testing.assert_allclose(got.z.u.numpy(), np.asarray(ref.z.u),
                               atol=1e-4)
    np.testing.assert_allclose(got.z.s[:, 0].numpy(),
                               np.asarray(ref.z.s[:, 0]), atol=1e-4)
    it_f = got.iterations.numpy().astype(float)
    it_c = composed.iterations.numpy().astype(float)
    assert np.all(np.abs(it_f - it_c) <= 0.05 * it_c + 3)
