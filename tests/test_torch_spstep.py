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
from spock_tpu import zv as jzv
from spock_tpu_torch import mpc
from spock_tpu_torch.algorithms import supermann as sp
from spock_tpu_torch.algorithms.common import bwhere, check_termination
from spock_tpu_torch.ops import spstep
from spock_tpu_torch.problem import step_size
from spock_tpu_torch.solver import Solver, zero_dual, zero_primal
from spock_tpu_torch.zv import tmap
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
    """Backtracking by retrial launches at the shrunken per-lane tau against
    sp_body's geometric backtracking, on car N=3 with acceptance rigged so
    every lane backtracks to the CP fallback: c1 ~ 0 kills K1 and sigma_k2
    huge kills K2.  Each iteration is one tau = 1 step and one retrial per
    backtrack, on every looping lane."""
    _, jdata, jmeta = jax_problem("car")
    pdata, pmeta = port_data(jdata, jmeta)
    rng = np.random.default_rng(23)
    x0 = torch.tensor(rng.uniform(-0.3, 0.3, (2, pmeta.nx)))
    opts = sp.SuperMannOpts(c1=1e-9, sigma_k2=1e9, max_backtracks=3)
    calls = []
    step, retrial = spstep.sp_step_ref, spstep.sp_retrial_ref

    def counted_step(*args, **kwargs):
        calls.append(("step", args[12][:, spstep.SC_TAU].tolist()))
        return step(*args, **kwargs)

    def counted_retrial(*args, **kwargs):
        scal, lanes = args[6], args[7]
        calls.append(("retrial", scal[lanes, spstep.SC_TAU].tolist()))
        return retrial(*args, **kwargs)

    monkeypatch.setattr(spstep, "sp_step_ref", counted_step)
    monkeypatch.setattr(spstep, "sp_retrial_ref", counted_retrial)
    n_it = 2
    cf = _iterate(pdata, pmeta, x0, opts, n_it, fused=True)
    # each iteration: the tau = 1 launch, then retrials at 0.5, 0.25, 0.125
    assert calls == [("step", [1.0, 1.0]), ("retrial", [0.5, 0.5]),
                     ("retrial", [0.25, 0.25]),
                     ("retrial", [0.125, 0.125])] * n_it
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


# ---------------------------------------------------------------------------
# Retrials: candidate phase and commit on the kept zbar and d
# ---------------------------------------------------------------------------


def looping_carry(pdata, pmeta, B_=B, seed=3, max_it=10):
    """The first fused carry from zero whose tau = 1 step leaves lanes
    looping: (carry, its tau = 1 step arguments, the plain step's outputs
    with the keep, the looping lanes)."""
    rng = np.random.default_rng(seed)
    x0 = torch.tensor(rng.uniform(-0.5, 0.5, (B_, pmeta.nx)))
    opts = sp.SuperMannOpts()
    c = sp.sp_init_fused(pmeta, x0, zero_primal(pmeta, (B_,), torch.float64,
                                                "cpu"),
                         zero_dual(pmeta, (B_,), torch.float64, "cpu"), opts)
    g = step_size(pdata)
    for _ in range(max_it):
        ph = c.it % 3
        args = sp.step_inputs(c, opts, ph, ~c.done, c.cache_valid, c.r_safe,
                              torch.ones(B_, dtype=torch.float64))
        out = spstep.sp_step_ref(pdata, pmeta, *args, g, g, **KNOBS)
        lanes = torch.nonzero(out[6][:, spstep.OC_LOOP] > 0.5).flatten()
        if lanes.numel():
            return c, args, out, lanes
        c = sp.sp_body_fused(pdata, pmeta, 1e-12, opts, phase=ph)(c)
    raise AssertionError("no lane looped")


def retrial_vs_step(pdata, pmeta, args, out, lanes, tau):
    """The retrial of ``lanes`` at ``tau`` on the kept zbar and d against
    sp_step_ref with no cache at tau: z_new and s on those lanes, output
    slots 0-12 (decisions exactly).  Returns the no-cache scalar pack."""
    g = step_size(pdata)
    scal = args[-1].clone()
    scal[:, spstep.SC_TAU] = tau
    z_new, s = tmap(torch.clone, out[0]), tmap(torch.clone, out[3])
    before = dict(spstep.LAUNCHES)
    sc = spstep.sp_step_retrial(pdata, pmeta, args[0], args[1], out[7],
                                args[9], scal, lanes, z_new, s, g, g,
                                **KNOBS)
    assert spstep.LAUNCHES == before  # CPU tensors: no launch
    scal_nc = scal.clone()
    scal_nc[:, spstep.SC_CACHE] = 0
    ref = spstep.sp_step_ref(pdata, pmeta, *args[:-1], scal_nc, g, g,
                             **KNOBS)
    for got_p, ref_p in ((z_new, ref[0]), (s, ref[3])):
        for a, b in zip(leaves_of(got_p), leaves_of(ref_p)):
            np.testing.assert_allclose(a[lanes].numpy(), b[lanes].numpy(),
                                       rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(sc[:, :3].numpy(),
                                  ref[6][lanes, :3].numpy())
    np.testing.assert_allclose(sc[:, :13].numpy(),
                               ref[6][lanes, :13].numpy(), rtol=RTOL,
                               atol=ATOL)
    return scal_nc, sc


def leaves_of(pair):
    from spock_tpu_torch.zv import leaves
    return leaves(pair)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_retrial_matches_step_without_cache(problem, k):
    """On the looping lanes of a real fused carry, the retrial at tau =
    beta^k (sp_retrial_ref: the candidate sweep and the commit on the kept
    zbar and d) equals sp_step_ref with no cache at that tau."""
    _, _, pdata, pmeta = problem
    _, args, out, lanes = looping_carry(pdata, pmeta)
    retrial_vs_step(pdata, pmeta, args, out, lanes, 0.5 ** k)


def _jax_pair(pair):
    z, v = pair
    return (jzv.Primal(**{f: jnp.asarray(getattr(z, f).numpy())
                          for f in z.__dataclass_fields__}),
            jzv.Dual(**{f: jnp.asarray(getattr(v, f).numpy())
                        for f in v.__dataclass_fields__
                        if getattr(v, f) is not None}))


def test_retrial_matches_jax_kernel(problem):
    """The same retrials against pallas_spstep.sp_step_fused with the
    retrial pack (no cache, tau = beta^k), on the looping lanes."""
    jdata, jmeta, pdata, pmeta = problem
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


def _recompute_body(data, meta, tol, opts, phase, gamma=None, sigma=None):
    """The fused iteration with backtracking by relaunching the whole step
    with no cache (phases 1-2 recomputed) for every lane: the retrial path
    before the retrial entry, kept here as the reference."""
    if gamma is None or sigma is None:
        gamma = sigma = step_size(data)
    m = opts.aa_window

    def body(c):
        B_ = c.done.shape[0]
        active = ~c.done

        def step(act, cache, r_safe, tau):
            return spstep.sp_step_fused(
                data, meta, *sp.step_inputs(c, opts, phase, act, cache,
                                            r_safe, tau),
                gamma, sigma, **KNOBS)

        ones = torch.ones((B_,), dtype=torch.float64)
        z_new, w, r, s, y, p, sc, _ = step(active, c.cache_valid, c.r_safe,
                                           ones)
        k1_first = sc[:, spstep.OC_K1] > 0.5
        looping = sc[:, spstep.OC_LOOP] > 0.5
        r_safe = sc[:, spstep.OC_RSAFE]
        xi1, xi2 = sc[:, spstep.OC_XI1], sc[:, spstep.OC_XI2]
        tau = torch.full((B_,), opts.beta, dtype=torch.float64)
        no_cache = torch.zeros((B_,), dtype=torch.bool)
        bt = 1
        while bt <= opts.max_backtracks and bool(looping.any()):
            z2, _, _, s2, _, _, sc2, _ = step(looping, no_cache, r_safe,
                                              tau)
            acc = looping & ((sc2[:, spstep.OC_K1] > 0.5)
                             | (sc2[:, spstep.OC_K2] > 0.5))
            z_new = bwhere(acc, z2, z_new)
            s = bwhere(acc, s2, s)
            r_safe = torch.where(acc, sc2[:, spstep.OC_RSAFE], r_safe)
            xi1 = torch.where(acc, sc2[:, spstep.OC_XI1], xi1)
            xi2 = torch.where(acc, sc2[:, spstep.OC_XI2], xi2)
            looping = looping & (sc2[:, spstep.OC_LOOP] > 0.5)
            tau = torch.where(looping, tau * opts.beta, tau)
            bt += 1
        conv, res0 = check_termination(xi1, xi2, c.res0, tol)
        return sp.SPCarryF(
            x0=c.x0, z=z_new[0], v=z_new[1], cache=w, r_prev=r, s_prev=s,
            MR=tuple(y if j == phase else c.MR[j] for j in range(m)),
            MP=tuple(p if j == phase else c.MP[j] for j in range(m)),
            r_safe=torch.where(active, r_safe, c.r_safe),
            res0=torch.where(active[:, None], res0, c.res0),
            done=c.done | (conv & active),
            niter=c.niter + active.to(torch.int32),
            xi1=torch.where(active, xi1, c.xi1),
            xi2=torch.where(active, xi2, c.xi2),
            it=c.it + 1, cache_valid=k1_first | c.done | conv,
            rnorm_c=sc[:, spstep.OC_RT], nMrz_c=sc[:, spstep.OC_NMRWZ],
            nMrv_c=sc[:, spstep.OC_NMRWV])

    return body


def test_farm_retrial_path_matches_recompute_path(problem, monkeypatch):
    """The warm-started farm on the fused step: retrials on the kept zbar
    and d for the looping lanes only give the farm of whole-step relaunches
    with no cache for every lane (plant states, controls, final iterates at
    1e-10, the same iteration counts)."""
    _, _, pdata, pmeta = problem
    rng = np.random.default_rng(7)
    x0 = rng.uniform(-0.5, 0.5, (3, pmeta.nx))
    ws = rng.integers(0, 2, size=(4, 3))

    def run():
        return mpc.simulate_async(pdata, pmeta, x0, ws, 1e-4, n_steps=3,
                                  device="cpu")

    retrials = []
    plain = spstep.sp_retrial_ref

    def counted(*args, **kwargs):
        retrials.append(int(args[7].numel()))
        return plain(*args, **kwargs)

    monkeypatch.setattr(spstep, "sp_retrial_ref", counted)
    before = dict(spstep.LAUNCHES)
    got = run()
    assert spstep.LAUNCHES == before
    assert retrials and min(retrials) >= 1
    monkeypatch.setattr(sp, "sp_body_fused", _recompute_body)
    ref = run()
    assert got.total_iterations == ref.total_iterations
    np.testing.assert_array_equal(got.iters_per_step.numpy(),
                                  ref.iters_per_step.numpy())
    for a, b in ((got.xs, ref.xs), (got.us, ref.us)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-10)
    for a, b in zip(leaves_of((got.z, got.v)), leaves_of((ref.z, ref.v))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-10)
