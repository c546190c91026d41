"""Node-sharded Chambolle-Pock (``spock_tpu_torch.parallel.bigtree``) over
2-3 gloo processes (``tests/torch_dist_worker.py``, 127.0.0.1) against the
JAX package's unsharded CP (in a process of its own,
``tests/jax_ref_worker.py``): the analogue of
``tests/test_node_sharding.py``'s CP test.  The partition and the share's
operators are held in ``tests/test_torch_partition.py``.
"""

import numpy as np
import pytest
import torch

from spock_tpu_torch import build
from spock_tpu_torch.models import server_heat
from spock_tpu_torch.parallel import bigtree

from tests.jax_ref_worker import Ref
from tests.torch_dist_worker import Job

torch.set_num_threads(1)


@pytest.mark.parametrize("d,ranks", [(2, 2), (2, 3), (3, 2), (3, 3)])
def test_node_sharded_cp_matches_jax_unsharded_cp(d, ranks, tmp_path):
    """server_heat N=6 nx=4, B=2, f64, 600 iterations at tol 1e-6 over 2-3
    gloo processes: the same iteration counts as the JAX package's
    unsharded CP and u within 1e-10 on every rank, four boundary exchanges
    and two reductions an iteration, and each rank's bytes as counted.
    (The JAX solve runs in a process of its own: tests/jax_ref_worker.py.)"""
    job = Job("cp", ranks, tmp_path, d)
    ref = Ref("cp", tmp_path, d).wait()
    iters, u, s0 = ref["iterations"], ref["u"], ref["s0"]
    out = job.wait()
    data, meta = build(server_heat.make_spec(N=6, nx=4, d=d),
                       dtype=torch.float64, device="cpu")
    for r, got in enumerate(out):
        np.testing.assert_array_equal(got["iterations"], iters)
        np.testing.assert_allclose(got["u"], u, atol=1e-10, rtol=0)
        np.testing.assert_allclose(got["s0"], s0, atol=1e-10, rtol=0)
        assert float(got["gathers"]) == 4.0 and float(got["reduces"]) == 2.0
        part = bigtree.Part.make(meta.tree, ranks, r)
        assert int(got["stage"]) == part.k
        assert int(got["rank_bytes"]) == bigtree.pair_bytes(
            meta, part.counts(), 2, 8)
