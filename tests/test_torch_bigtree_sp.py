"""Node-sharded SuperMann (``parallel.bigtree.run_sp_sharded``) over 2 gloo
processes against the port's unsharded solve and the JAX package's
``Solver``, one iteration from the same carry against the unsharded
composed ``sp_body``, and the polytope solve of BASELINE config 4's
constraint (the analogues of ``tests/test_node_sharding.py``'s SuperMann
and polytope tests, whose tolerances they keep).
"""

import numpy as np
import torch

from spock_tpu_torch import build
from spock_tpu_torch.models import server_heat
from spock_tpu_torch.solver import Solver

from tests.jax_ref_worker import Ref
from tests.torch_dist_worker import Job, launch

torch.set_num_threads(1)


def test_node_sharded_supermann_matches_unsharded(tmp_path):
    """server_heat N=5 nx=4 d=3, B=2, f64, tol 1e-4: the sharded and both
    unsharded solves converge, root controls and s_1 within 2e-2 (the
    determinacy scale of a tol 1e-4 solution: SuperMann's decisions
    amplify rounding, so trajectories are not compared); one iteration
    from the same carry within 1e-12.  (The JAX solve runs in a process of
    its own: tests/jax_ref_worker.py.)"""
    job = Job("sp", 2, tmp_path)
    jax_ref = Ref("sp", tmp_path)
    x0 = np.random.default_rng(4).uniform(-0.5, 0.5, (2, 4))
    data, meta = build(server_heat.make_spec(N=5, nx=4, d=3),
                       dtype=torch.float64, device="cpu")
    pres = Solver(data, meta, device="cpu").solve(x0, tol=1e-4)
    jres = jax_ref.wait()
    assert bool(pres.converged.all()) and np.all(jres["status"] == 0)
    for got in job.wait():
        assert np.all(got["status"] == 0)
        for ref_u, ref_s in ((pres.z.u[:, :, 0].numpy(), pres.z.s[:, 0]),
                             (jres["u"][:, :, 0], jres["s0"])):
            np.testing.assert_allclose(got["u_root"], ref_u, atol=2e-2)
            np.testing.assert_allclose(got["s1"], np.asarray(ref_s),
                                       atol=2e-2)
        assert float(got["one_iteration_err"]) <= 1e-12


def test_node_sharded_polytope_solve_holds_the_band(tmp_path):
    """BASELINE config 4's constraint at N=8 d=3 (3,280 nodes), -2 <= 1'x <=
    2 at every node, over 2 processes: converged to tol 1e-3 within 400
    iterations, the band held within 1e-2 at every node."""
    for got in launch("polytope", 2, tmp_path):
        assert np.all(got["status"] == 0)
        g = got["g"]
        assert g.shape == (3280,)
        assert np.all(g <= 2.0 + 1e-2) and np.all(g >= -2.0 - 1e-2)
