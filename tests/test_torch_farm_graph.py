"""The graphed farm on the card: ``mpc.simulate_async`` with
``iters_per_launch`` on the fused step runs each chunk as one replay of a
CUDA graph, with no host sync inside an iteration.  Held here: the graphed
farm bitwise equal to the eager one, a resumed graphed farm equal to one
run, a capture that meets a host sync raising, and a farm iteration that
makes no host sync (``torch.cuda.set_sync_debug_mode("error")``).  The
tests need a card and skip without one; the file imports no JAX:
  python -m pytest tests/test_torch_farm_graph.py -m cuda --noconftest
  -o addopts="" -p no:cacheprovider
The chunks' logic is held on the CPU in tests/test_torch_farm_chunks.py."""

import numpy as np
import pytest
import torch

from spock_tpu_torch import build, mpc
from spock_tpu_torch.algorithms import supermann as sp
from spock_tpu_torch.models import server_heat
from spock_tpu_torch.ops import spstep
from spock_tpu_torch.solver import zero_dual, zero_primal
from spock_tpu_torch.zv import leaves

B, T, TOL = 16, 3, 1e-3


def _problem(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    data, meta = build(server_heat.make_spec(N=5, nx=6, d=2), dtype=dtype)
    rng = np.random.default_rng(3)
    x0 = torch.tensor(rng.uniform(-0.5, 0.5, (B, meta.nx)), dtype=dtype,
                      device="cuda")
    ws = torch.tensor(rng.integers(0, 2, (T, B)), device="cuda")
    assert sp.use_fused_step(data, meta, sp.SuperMannOpts())
    return data, meta, x0, ws


def _fields(res):
    return ([res.steps_done, res.iters_per_step, res.us, res.xs]
            + leaves((res.z, res.v)))


def _same(got, ref):
    assert got.total_iterations == ref.total_iterations
    for a, b in zip(_fields(got), _fields(ref)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_graphed_farm_equals_eager_farm(dtype):
    """server_heat N=5 at B = 16: the farm in graphed chunks of 6 (and the
    same farm again, on the graph already captured) is bitwise the eager
    farm, with the wasted iterations after its end; each replay adds the
    captured launches to the counts."""
    data, meta, x0, ws = _problem(dtype)
    mpc.clear_graphs()
    ref = mpc.simulate_async(data, meta, x0, ws, TOL, n_steps=T)
    assert bool((ref.steps_done == T).all())
    for captures in (1, 0):
        before = dict(spstep.LAUNCHES)
        got = mpc.simulate_async(data, meta, x0, ws, TOL, n_steps=T,
                                 iters_per_launch=6)
        run = got.run
        assert run["graphed"] and run["chunks"] >= 1
        assert run["captures"] == captures
        assert run["executed"] == ref.total_iterations + run["wasted"]
        _same(got, ref)
        for name in ("sp_step_fused", "sp_step_backtrack"):
            assert (spstep.LAUNCHES[name] - before[name]
                    == run["executed"]), name


@pytest.mark.cuda
def test_resumed_graphed_farm_equals_one_run():
    """A graphed farm stopped by its budget after 31 iterations (a graph of
    chunks of 6 from phase 0, then one eager iteration) and resumed from its
    state (a graph from phase 1) is bitwise the one eager run."""
    data, meta, x0, ws = _problem(torch.float32)
    mpc.clear_graphs()
    ref = mpc.simulate_async(data, meta, x0, ws, TOL, n_steps=T)
    first = mpc.simulate_async(data, meta, x0, ws, TOL, n_steps=T,
                               max_total_iters=31, iters_per_launch=6)
    assert first.total_iterations == 31
    assert first.run["eager_chunks"] == 1
    got = mpc.simulate_async(data, meta, x0, ws, TOL, n_steps=T,
                             resume=first.state, iters_per_launch=6)
    assert got.run["captures"] == 1
    _same(got, ref)


@pytest.mark.cuda
def test_capture_that_meets_a_host_sync_raises(monkeypatch):
    """A farm iteration that reads a device value on the host cannot be
    captured: the capture raises, and nothing falls back to the eager
    loop."""
    data, meta, x0, ws = _problem(torch.float32)
    mpc.clear_graphs()
    plain = sp.sp_body_fused

    def syncing(*args, **kwargs):
        body = plain(*args, **kwargs)

        def run(c):
            if bool(c.done.all()):  # a host sync
                return c
            return body(c)

        return run

    monkeypatch.setattr(sp, "sp_body_fused", syncing)
    with pytest.raises(RuntimeError):
        mpc.simulate_async(data, meta, x0, ws, TOL, n_steps=T,
                           iters_per_launch=6)
    mpc.clear_graphs()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_farm_iteration_makes_no_host_sync():
    """Three farm iterations on the fused step (the step, the one-launch
    backtracking, termination, records and refill) under
    set_sync_debug_mode("error"), after one iteration that loads the
    kernels."""
    data, meta, x0, ws = _problem(torch.float32)
    opts = sp.SuperMannOpts()
    z0 = zero_primal(meta, (B,), data.dtype, data.device)
    v0 = zero_dual(meta, (B,), data.dtype, data.device)
    state = dict(
        sp=sp.sp_init_fused(meta, x0, z0, v0, opts),
        step_idx=torch.zeros((B,), dtype=torch.int64, device="cuda"),
        iters_rec=torch.zeros((T, B), dtype=torch.int32, device="cuda"),
        us_rec=torch.zeros((T, B, meta.nu), dtype=data.dtype, device="cuda"),
        total=torch.zeros((), dtype=torch.int64, device="cuda"))
    bodies = mpc._bodies(data, meta, TOL, opts, True, True)
    n_steps = torch.tensor(T, device="cuda")

    def chunk(st, n):
        return mpc._simulate_async_chunk(data, meta, ws, n_steps, opts, n,
                                         st, bodies, True)[1]

    state = chunk(state, 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = chunk(state, 3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(state["total"]) == 4
