"""The port's fused SuperMann step on two-sided polytope rows and per-node
risk, float64 on the CPU: the step against the JAX package's fused-step
Pallas kernels (interpret mode) with identical K1/K2 decisions, and the
fused carry against the composed SuperMann iteration.  On the CPU the step
wrapper takes its plain version.  Solves and the farm on this class are in
tests/test_torch_wide_solve.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spock_tpu import build as jbuild
from spock_tpu.ops import pallas_spstep, pallas_spstep_lt
from spock_tpu_torch.algorithms import supermann as sp
from spock_tpu_torch.ops import spstep
from spock_tpu_torch.solver import zero_dual, zero_primal
from spock_tpu_torch.problem import step_size
from tests.test_torch_spstep import (
    ATOL, GAMMA, KNOBS, PACKS, RTOL, SIGMA, _compare, _jax_pair,
    looping_carry, retrial_vs_step)
from tests.torch_parity import SMALL, port_data, rand_pair, to_jax, to_port
from tests.torch_parity import release_jax_executables  # noqa: F401

torch.set_num_threads(1)

B = 2


@pytest.fixture(scope="module", params=["poly", "navar"])
def problem(request):
    """The JAX step kernels' wider class, carried across (N=3 nx=3)."""
    jdata, jmeta = jbuild(SMALL[request.param](), dtype=jnp.float64)
    pdata, pmeta = port_data(jdata, jmeta)
    assert pallas_spstep.supported(jmeta, jdata)
    assert spstep.supported(pmeta, pdata)
    return request.param, jdata, jmeta, pdata, pmeta


def _inputs(jmeta):
    rng = np.random.default_rng(17)
    pairs = [rand_pair(rng, jmeta, batch=(B,)) for _ in range(8)]
    return pairs, rng.uniform(-0.5, 0.5, (B, jmeta.nx))


def _port_step(pdata, pmeta, pairs, x0, scal):
    (z, v), *rest = [to_port(q) for q in pairs]
    before = dict(spstep.LAUNCHES)
    out = spstep.sp_step_fused(pdata, pmeta, z, v, *rest, to_port(x0),
                               torch.tensor(scal, dtype=torch.float64), GAMMA,
                               SIGMA, **KNOBS)
    assert spstep.LAUNCHES == before  # CPU tensors: no launch
    return out


@pytest.mark.parametrize("pack", ["warm", "cached_active", "retrial",
                                  "fallback"])
def test_step_matches_jax_kernel(problem, pack):
    """One step against pallas_spstep.sp_step_fused at any tau: the six
    output pairs (polytope blocks included) at rtol 1e-9 / atol 1e-10 and
    the K1 / K2 / loop decisions exactly."""
    _, jdata, jmeta, pdata, pmeta = problem
    pairs, x0 = _inputs(jmeta)
    scal = np.array(PACKS[pack])
    trios = [pallas_spstep.pack_pair(jmeta, *to_jax(q)) for q in pairs]
    ref = pallas_spstep.sp_step_fused(
        jdata, jmeta, *trios, jnp.asarray(x0), jnp.asarray(scal), GAMMA,
        SIGMA, **KNOBS, interpret=True)
    ref_pairs = [pallas_spstep.unpack_pair(jmeta, t) for t in ref[:6]]
    got = _port_step(pdata, pmeta, pairs, x0, scal)
    if jmeta.nc_nl:
        assert got[0][1].pnl is not None and got[0][1].plf is not None
    _compare(got, ref_pairs, ref[6])


def test_fused_iterations_match_composed_body(problem):
    """Four fused iterations against four of the composed sp_body from the
    same state (tests/test_fused_step.py's polytope and per-node-risk
    checks, within the port): iterates at rtol 1e-9 / atol 1e-10, equal
    iteration counts."""
    _, _, jmeta, pdata, pmeta = problem
    rng = np.random.default_rng(11)
    x0 = torch.tensor(rng.uniform(-0.5, 0.5, (3, pmeta.nx)))
    opts = sp.SuperMannOpts()
    assert sp.use_fused_step(pdata, pmeta, opts)
    z0 = zero_primal(pmeta, (3,), torch.float64, "cpu")
    v0 = zero_dual(pmeta, (3,), torch.float64, "cpu")
    cf = sp.sp_init_fused(pmeta, x0, z0, v0, opts)
    c = sp.sp_init(pmeta, x0, z0, v0, opts)
    body = sp.sp_body(pdata, pmeta, 1e-12, opts)
    for k in range(4):
        cf = sp.sp_body_fused(pdata, pmeta, 1e-12, opts, phase=k % 3)(cf)
        c = body(c)
    for got, ref in ((cf.z, c.z), (cf.v, c.v)):
        for fl in got.__dataclass_fields__:
            a, b = getattr(got, fl), getattr(ref, fl)
            assert (a is None) == (b is None), fl
            if b is not None:
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                           atol=1e-10, err_msg=fl)
    np.testing.assert_array_equal(cf.niter.numpy(), c.niter.numpy())


def test_step_matches_lane_tiled_jax_kernel():
    """The step at tau = 1 against pallas_spstep_lt.sp_step_fused on
    polytope rows and per-node risk at once."""
    jdata, jmeta = jbuild(SMALL["poly_navar"](), dtype=jnp.float64)
    pdata, pmeta = port_data(jdata, jmeta)
    assert pallas_spstep_lt.supported(jmeta, jdata)
    pairs, x0 = _inputs(jmeta)
    scal = np.array(PACKS["warm"])
    trios = [pallas_spstep_lt.pack_pair(jmeta, *to_jax(q)) for q in pairs]
    ref = pallas_spstep_lt.sp_step_fused(
        jdata, jmeta, *trios, jnp.asarray(x0),
        jnp.asarray(scal[:, :spstep.SC_TAU]), GAMMA, SIGMA, **KNOBS,
        interpret=True)
    ref_pairs = [pallas_spstep_lt.unpack_pair(jmeta, t) for t in ref[:6]]
    _compare(_port_step(pdata, pmeta, pairs, x0, scal), ref_pairs, ref[6])


def test_retrial_matches_step_without_cache_and_jax_kernel(problem):
    """On the looping lanes of a real fused carry on polytope rows or
    per-node risk, the retrial at tau = beta^k, k = 1, 2, 3, on the kept
    zbar and d equals sp_step_ref with no cache at that tau, and the JAX
    step kernel with the retrial pack (interpret mode)."""
    _, jdata, jmeta, pdata, pmeta = problem
    _, args, out, lanes = looping_carry(pdata, pmeta)
    g = step_size(pdata)
    trios = [pallas_spstep.pack_pair(jmeta, *_jax_pair(q))
             for q in [args[:2]] + list(args[2:9])]
    for k in (1, 2, 3):
        scal_nc, sc = retrial_vs_step(pdata, pmeta, args, out, lanes,
                                      0.5 ** k)
        ref = pallas_spstep.sp_step_fused(
            jdata, jmeta, *trios, jnp.asarray(args[9].numpy()),
            jnp.asarray(scal_nc.numpy()), g, g, **KNOBS, interpret=True)
        rows = lanes.numpy()
        np.testing.assert_array_equal(sc[:, :3].numpy(),
                                      np.asarray(ref[6])[rows, :3])
        np.testing.assert_allclose(sc[:, :13].numpy(),
                                   np.asarray(ref[6])[rows, :13], rtol=RTOL,
                                   atol=ATOL)


def test_retrial_on_polytope_and_per_node_risk_at_once():
    """The retrial against sp_step_ref with no cache on polytope rows and
    per-node risk at once."""
    jdata, jmeta = jbuild(SMALL["poly_navar"](), dtype=jnp.float64)
    pdata, pmeta = port_data(jdata, jmeta)
    _, args, out, lanes = looping_carry(pdata, pmeta)
    for k in (1, 2, 3):
        retrial_vs_step(pdata, pmeta, args, out, lanes, 0.5 ** k)
