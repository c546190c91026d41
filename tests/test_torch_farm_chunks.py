"""The port's async farm in chunks (``mpc.simulate_async``'s
``iters_per_launch`` and ``resume``), float64 on the CPU, where a chunk runs
eagerly: the chunked farm against the unchunked one (bitwise) and against
the JAX farm in chunks, a resumed farm against one run, the budget, the
iterations after the farm's end; and the one-launch backtracking's plain
version against the host retrial loop it replaced.  The CUDA-graph chunks
are held on the card (tests/test_torch_farm_graph.py, chip_smoke.py).

The file holds five test items: pytest-xdist's ``--dist loadfile`` queues
files by their number of tests, largest first, and a short file joins the
queue's tail, behind the repository's long JAX files, whose placement on
the workers it then leaves as it was."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spock_tpu import build as jbuild
from spock_tpu import mpc as jmpc
from spock_tpu.models import server_heat as jsh
from spock_tpu_torch import mpc
from spock_tpu_torch.algorithms import supermann as sp
from spock_tpu_torch.ops import spstep
from spock_tpu_torch.problem import step_size
from spock_tpu_torch.solver import zero_dual, zero_primal
from spock_tpu_torch.zv import leaves, tmap
from tests.torch_parity import port_data
from tests.torch_parity import release_jax_executables  # noqa: F401

torch.set_num_threads(1)

B, T, TOL = 3, 4, 1e-4
KNOBS = dict(c1=0.99, sigma_k2=0.1, lam=1.0, lam_sp=1.0)


@pytest.fixture(scope="module")
def problem():
    """server_heat N=4 nx=4 d=2, the size of tests/test_mpc_and_sharding.py,
    with its inputs and the unchunked port farm."""
    jdata, jmeta = jbuild(jsh.make_spec(N=4, nx=4, d=2), dtype=jnp.float64)
    pdata, pmeta = port_data(jdata, jmeta)
    rng = np.random.default_rng(7)
    x0 = rng.uniform(-0.5, 0.5, (B, pmeta.nx))
    ws = rng.integers(0, pmeta.tree.d, (T, B))
    ref = farm(pdata, pmeta, x0, ws)
    assert bool((ref.steps_done == T).all())
    return jdata, jmeta, pdata, pmeta, x0, ws, ref


def farm(data, meta, x0, ws, **kw):
    return mpc.simulate_async(data, meta, x0, ws, tol=TOL, n_steps=T,
                              device="cpu", **kw)


def assert_same(got, ref):
    """Bitwise-equal results."""
    assert got.total_iterations == ref.total_iterations
    for a, b in zip([got.steps_done, got.iters_per_step, got.us, got.xs]
                    + leaves((got.z, got.v)),
                    [ref.steps_done, ref.iters_per_step, ref.us, ref.xs]
                    + leaves((ref.z, ref.v))):
        assert torch.equal(a, b)


def _host_retrial_loop(data, meta, c, keep, scal, sc, z_new, s, opts, g):
    """The backtracking of the fused iteration as the farm made it before
    the one-launch backtrack: a host loop of retrials over the lane list
    ``torch.nonzero(looping)``, taking a trial's r_safe and residuals where
    it accepts.  Returns (r_safe, xi1, xi2, looping)."""
    B_ = sc.shape[0]
    looping = sc[:, spstep.OC_LOOP] > 0.5
    r_safe = sc[:, spstep.OC_RSAFE]
    xi1, xi2 = sc[:, spstep.OC_XI1], sc[:, spstep.OC_XI2]
    tau = torch.full((B_,), opts.beta, dtype=torch.float64)
    for _ in range(opts.max_backtracks):
        lanes = torch.nonzero(looping).flatten()
        if lanes.numel() == 0:
            break
        sc_in = scal.clone()
        sc_in[:, spstep.SC_RSAFE] = r_safe
        sc_in[:, spstep.SC_TAU] = tau
        sc2 = spstep.sp_retrial_ref(data, meta, c.z, c.v, keep, c.x0, sc_in,
                                    lanes, z_new, s, g, g, **KNOBS)
        acc = (sc2[:, spstep.OC_K1] > 0.5) | (sc2[:, spstep.OC_K2] > 0.5)

        def take(old, slot):
            return old.index_copy(0, lanes, torch.where(
                acc, sc2[:, slot], old[lanes]))

        r_safe = take(r_safe, spstep.OC_RSAFE)
        xi1 = take(xi1, spstep.OC_XI1)
        xi2 = take(xi2, spstep.OC_XI2)
        looping = looping.index_copy(0, lanes, sc2[:, spstep.OC_LOOP] > 0.5)
        tau = torch.where(looping, tau * opts.beta, tau)
    return r_safe, xi1, xi2, looping


@pytest.mark.parametrize("k", [3, 25])
def test_chunked_farm_equals_unchunked(problem, k):
    """Chunks of k iterations with one check each give the unchunked farm
    exactly, the iterations after the farm's end included (k = 25 wastes up
    to 24); and the JAX farm in chunks of 25 at test_torch_mpc.py's
    tolerances, with its step counts."""
    jdata, jmeta, pdata, pmeta, x0, ws, ref = problem
    got = farm(pdata, pmeta, x0, ws, iters_per_launch=k)
    assert_same(got, ref)
    run = got.run
    assert run["eager_chunks"] == -(-ref.total_iterations // k)
    assert run["wasted"] == run["executed"] - ref.total_iterations < k
    assert not run["graphed"] and run["chunks"] == 0
    jref = jmpc.simulate_async(jdata, jmeta, jnp.asarray(x0), jnp.asarray(ws),
                               tol=TOL, n_steps=T, iters_per_launch=25)
    np.testing.assert_array_equal(got.steps_done.numpy(),
                                  np.asarray(jref.steps_done))
    np.testing.assert_allclose(got.us.numpy(), np.asarray(jref.us), atol=1e-3)
    np.testing.assert_allclose(got.xs.numpy(), np.asarray(jref.xs), atol=5e-3)


def test_resumed_farm_equals_one_run(problem):
    """A farm stopped by its budget after 40 iterations (phase 40 mod 3 = 1)
    and resumed from its state gives the one run exactly, iteration by
    iteration (k = 0) and in chunks of 4; the first call's result is left as
    it was."""
    _, _, pdata, pmeta, x0, ws, ref = problem
    for k in (0, 4):
        first = farm(pdata, pmeta, x0, ws, max_total_iters=40,
                     iters_per_launch=k)
        assert first.total_iterations == 40
        assert not bool((first.steps_done == T).all())
        kept = [a.clone() for a in (first.iters_per_step, first.us)]
        # x0, z0 and v0 are unread on resume
        got = farm(pdata, pmeta, x0 + 1.0, ws, resume=first.state,
                   iters_per_launch=k)
        assert_same(got, ref)
        assert all(torch.equal(a, b)
                   for a, b in zip(kept, (first.iters_per_step, first.us)))


def test_budget_and_the_farm_end(problem):
    """max_total_iters = 100 stops every chunk size at exactly 100
    iterations (k = 7: 14 chunks, then 2 iterations eagerly), with the
    results of the iteration-at-a-time farm cut there; and iterations of a
    chunk after every lane has done its steps leave z, v, the records, the
    plant states, the steps done and total as they were."""
    _, _, pdata, pmeta, x0, ws, ref = problem
    cut = farm(pdata, pmeta, x0, ws, max_total_iters=100)
    for k in (1, 7, 25):
        got = farm(pdata, pmeta, x0, ws, max_total_iters=100,
                   iters_per_launch=k)
        assert got.total_iterations == 100
        assert got.run["executed"] == 100
        assert_same(got, cut)

    state = ref.state
    bodies = mpc._bodies(pdata, pmeta, TOL, sp.SuperMannOpts(), True, True)
    res, after = mpc._simulate_async_chunk(
        pdata, pmeta, torch.as_tensor(ws), torch.tensor(T),
        sp.SuperMannOpts(), 5, state, bodies, True)
    assert after["sp"].it == state["sp"].it + 5
    assert int(res.total_iterations) == ref.total_iterations
    for a, b in zip([res.steps_done, res.iters_per_step, res.us, res.xs]
                    + leaves((res.z, res.v)),
                    [ref.steps_done, ref.iters_per_step, ref.us, ref.xs]
                    + leaves((ref.z, ref.v))):
        assert torch.equal(a, b)


def test_backtrack_equals_the_host_retrial_loop(problem):
    """sp_backtrack_ref (through the sp_step_backtrack wrapper) against the
    host retrial loop it replaced, lane by lane, on the fused carries of a
    solve from zero (B = 6 lanes, 12 iterations): z_new and s, r_safe and
    the residuals bitwise; c1 = 0.3 makes more lanes loop longer."""
    _, _, pdata, pmeta, _, _, _ = problem
    for c1 in (0.99, 0.3):
        opts = sp.SuperMannOpts(c1=c1, max_backtracks=4)
        knobs = dict(KNOBS, c1=c1)
        rng = np.random.default_rng(11)
        B_ = 6
        x0 = torch.tensor(rng.uniform(-0.5, 0.5, (B_, pmeta.nx)))
        c = sp.sp_init_fused(
            pmeta, x0, zero_primal(pmeta, (B_,), torch.float64, "cpu"),
            zero_dual(pmeta, (B_,), torch.float64, "cpu"), opts)
        g = step_size(pdata)
        looped = 0
        for _ in range(12):
            ph = c.it % 3
            args = sp.step_inputs(c, opts, ph, ~c.done, c.cache_valid,
                                  c.r_safe,
                                  torch.ones(B_, dtype=torch.float64))
            z_new, _, _, s, _, _, sc, keep = spstep.sp_step_fused(
                pdata, pmeta, *args, g, g, **knobs)
            zh, sh = tmap(torch.clone, z_new), tmap(torch.clone, s)
            r_safe, xi1, xi2, loop_h = _host_retrial_loop(
                pdata, pmeta, c, keep, args[-1], sc, zh, sh, opts, g)
            out = spstep.sp_step_backtrack(
                pdata, pmeta, c.z, c.v, keep, c.x0, args[-1], sc, z_new, s,
                g, g, opts.beta, opts.max_backtracks, **knobs)
            for a, b in zip(leaves((z_new, s)), leaves((zh, sh))):
                assert torch.equal(a, b)
            assert torch.equal(out[:, spstep.OC_RSAFE], r_safe)
            assert torch.equal(out[:, spstep.OC_XI1], xi1)
            assert torch.equal(out[:, spstep.OC_XI2], xi2)
            assert torch.equal(out[:, spstep.OC_LOOP] > 0.5, loop_h)
            looped += int((sc[:, spstep.OC_LOOP] > 0.5).sum())
            c = sp.sp_body_fused(pdata, pmeta, 1e-12, opts, phase=ph)(c)
        assert looped >= 3, c1
