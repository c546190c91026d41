"""Lane sharding over processes (``spock_tpu_torch.parallel.mesh`` on
torch.distributed, gloo on the CPU): the analogue of
``tests/test_multihost.py`` and of the two sharded tests of
``tests/test_mpc_and_sharding.py``.  Two worker processes
(``tests/torch_dist_worker.py``, 127.0.0.1) each solve their block of
lanes with the ordinary ``Solver`` and farm; the gathered batch is held
against single-process solves."""

import numpy as np
import pytest
import torch

from spock_tpu_torch import build, mpc
from spock_tpu_torch.models import server_heat
from spock_tpu_torch.parallel import mesh as pmesh

from tests.jax_ref_worker import Ref
from tests.torch_dist_worker import Job

torch.set_num_threads(1)


def test_lane_sharded_solve_and_farm_match_one_process(tmp_path):
    """server_heat N=3 nx=3 d=2, B=8 lanes, f64, tol 1e-6: the gathered
    controls and objectives of the 2-process solve against the JAX
    package's single-process Solver at 1e-5 (test_multihost's check), on
    every rank; the lane-sharded async farm (N=4 nx=4, B=4, 3 steps, tol
    1e-4) against the unsharded farm bitwise: lanes are independent and no
    collective runs inside the loop.  The lanes' controls differ from one
    another by far more than roundoff, so a lane given its neighbour's
    place fails.  (The JAX solve runs in a process of its own:
    tests/jax_ref_worker.py.)"""
    job = Job("lanes", 2, tmp_path)
    jax_ref = Ref("lanes", tmp_path)
    data, meta = build(server_heat.make_spec(N=4, nx=4, d=2),
                       dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(5)
    fx0 = rng.uniform(-0.5, 0.5, (4, meta.nx))
    ws = torch.as_tensor(rng.integers(0, meta.tree.d, (3, 4)))
    far = mpc.simulate_async(data, meta, torch.as_tensor(fx0), ws, tol=1e-4,
                             n_steps=3, device="cpu")
    us = far.us.numpy()  # [T, B, nu]
    assert min(np.abs(us[:, i] - us[:, j]).max() for i in range(4)
               for j in range(i)) > 1e-2
    ref = jax_ref.wait()
    assert np.all(ref["status"] == 0)
    for got in job.wait():
        assert np.all(got["status"] == 0)
        np.testing.assert_allclose(got["u"], ref["u"], atol=1e-5)
        np.testing.assert_allclose(got["s0"], ref["s0"], atol=1e-5)
        np.testing.assert_array_equal(got["steps_done"], [3, 3, 3, 3])
        np.testing.assert_array_equal(got["us"], us)


def test_one_process_mesh_shards_and_gathers_lanes():
    """A process alone makes a one-rank gloo mesh on the CPU: shard_batch
    keeps every lane (and refuses a batch that does not divide), replicate
    moves numpy data to tensors, gather_batch returns the batch (flags
    too), and a mesh of two ranks is refused."""
    mesh = pmesh.make_mesh(device="cpu")
    assert (mesh.axis, mesh.size, mesh.rank) == ("batch", 1, 0)
    x = np.arange(12.0).reshape(6, 2)
    got = pmesh.shard_batch((x, torch.ones(6, dtype=torch.bool)), mesh)
    np.testing.assert_array_equal(got[0].numpy(), x)
    back = pmesh.gather_batch(got, mesh)
    assert back[1].dtype == torch.bool and bool(back[1].all())
    np.testing.assert_array_equal(back[0].numpy(), x)
    rep = pmesh.replicate((x, None), mesh)
    assert torch.is_tensor(rep[0]) and rep[1] is None
    with pytest.raises(ValueError, match="2 ranks asked of a job of 1"):
        pmesh.make_mesh(2, device="cpu")
    pmesh.init_distributed(num_processes=1)  # a no-op


def test_constrain_hook_runs_every_iteration_without_the_fused_step():
    """``constrain`` (the JAX package's sharding hook) is applied to z and
    to v at every iteration of ``Solver`` (CP and SuperMann), ``run_cp``
    and ``sp_body``; with it ``use_fused_step`` refuses the fused step, and
    an identity hook leaves the composed solve bitwise unchanged."""
    from spock_tpu_torch.algorithms import supermann as sp
    from spock_tpu_torch.solver import Solver

    data, meta = build(server_heat.make_spec(N=3, nx=3, d=2),
                       dtype=torch.float64, device="cpu")
    calls = []

    def hook(tree):
        calls.append(type(tree).__name__)
        return tree

    opts = sp.SuperMannOpts()
    assert sp.use_fused_step(data, meta, opts)
    assert not sp.use_fused_step(data, meta, opts, constrain=hook)
    x0 = np.random.default_rng(0).uniform(-0.5, 0.5, (2, 3))
    for algorithm in ("cp", "spock"):
        calls.clear()
        res = Solver(data, meta, algorithm=algorithm, device="cpu",
                     constrain=hook).solve(x0, tol=1e-5)
        ref = Solver(data, meta, algorithm=algorithm, device="cpu",
                     fused_step=False).solve(x0, tol=1e-5)
        its = int(res.iterations.max())
        assert calls == ["Primal", "Dual"] * its
        for a, b in ((res.z.u, ref.z.u), (res.v.y, ref.v.y),
                     (res.iterations, ref.iterations)):
            assert torch.equal(a, b)
