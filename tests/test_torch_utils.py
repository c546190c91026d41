"""The port's utilities against the JAX package's: the reference-layout flat
vectors (``utils.refvec``) and the node permutation they use, checkpoints
that load across the two packages (``utils.checkpoint``), and the profiling
helpers (``utils.profiling``) on the CPU."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from spock_tpu.tree import UniformTree as JTree
from spock_tpu.utils import checkpoint as jcheckpoint
from spock_tpu.utils import refvec as jrefvec
from spock_tpu_torch.tree import UniformTree
from spock_tpu_torch.utils import checkpoint, profiling, refvec
from tests.torch_parity import (
    jax_problem, port_data, rand_pair, to_jax, to_port)
from tests.torch_parity import release_jax_executables  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("N,d", [(2, 2), (3, 2), (4, 3), (5, 2), (3, 5)])
def test_perm_to_reference_matches_jax(N, d):
    np.testing.assert_array_equal(UniformTree(N, d).perm_to_reference(),
                                  JTree(N, d).perm_to_reference())


@pytest.fixture(scope="module", params=["car", "poly"])
def problem(request):
    """car N=3 d=2 (test_utils.py's problem) and server_heat N=3 with
    polytope rows (the pnl/plf blocks), with a random (z, v) at batch 2."""
    _, jdata, jmeta = jax_problem(request.param)
    _, pmeta = port_data(jdata, jmeta)
    z, v = rand_pair(np.random.default_rng(0), jmeta, batch=(2,))
    return jmeta, pmeta, z, v


def test_refvec_matches_jax_and_round_trips(problem):
    jmeta, pmeta, z, v = problem
    pz, pv = to_port(z), to_port(v)
    zf, vf = refvec.primal_to_ref(pmeta, pz), refvec.dual_to_ref(pmeta, pv)
    assert isinstance(zf, np.ndarray) and zf.shape == (2, pmeta.nz)
    np.testing.assert_array_equal(zf, jrefvec.primal_to_ref(jmeta, to_jax(z)))
    np.testing.assert_array_equal(vf, jrefvec.dual_to_ref(jmeta, to_jax(v)))
    z2 = refvec.primal_from_ref(pmeta, zf)
    for f in dataclasses.fields(pz):
        torch.testing.assert_close(getattr(z2, f.name), getattr(pz, f.name),
                                   rtol=0, atol=0)
    v2 = refvec.dual_from_ref(pmeta, vf[..., : pmeta.nv])
    for f in dataclasses.fields(pv):
        if f.name in ("pnl", "plf"):  # appended blocks: not read back
            continue
        torch.testing.assert_close(getattr(v2, f.name), getattr(pv, f.name),
                                   rtol=0, atol=0)


def test_refvec_layout_is_the_references(problem):
    """test_utils.py's layout test on the port: reference node r's state
    sits at zf[r*nx:(r+1)*nx], and reference child k of reference parent p
    is our child k of our parent."""
    _, pmeta, z, _ = problem
    t = pmeta.tree
    zf = refvec.primal_to_ref(pmeta, to_port(z))[0]
    x = np.asarray(z.x)[0]
    perm = t.perm_to_reference()
    for our in range(t.n):
        np.testing.assert_array_equal(
            zf[perm[our] * pmeta.nx: (perm[our] + 1) * pmeta.nx], x[:, our])
    for our in range(t.n_nonleaf):
        for k, j in enumerate(t.children(our)):
            st = t.stage_of(j)
            ref_par_loc = perm[our] - t.stage_offset(st - 1)
            assert perm[j] == t.stage_offset(st) + ref_par_loc * t.d + k


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_loads_across_packages(problem, tmp_path, writer):
    """A warm start saved by either package loads in the other: the same
    .npz keys (z.<field>, v.<field>, extra.<name>)."""
    _, _, z, v = problem
    path = os.path.join(tmp_path, "state.npz")
    if writer == "port":
        checkpoint.save_state(path, to_port(z), to_port(v), step=np.int32(7))
        jz, jv, extras = jcheckpoint.load_state(path)
        got_z, got_v = jz, jv
    else:
        jcheckpoint.save_state(path, to_jax(z), to_jax(v), step=np.int32(7))
        got_z, got_v, extras = checkpoint.load_state(path, device="cpu")
        assert got_z.x.device.type == "cpu"
        assert got_z.x.dtype == torch.float64
    assert int(extras["step"]) == 7
    for want, got in ((z, got_z), (v, got_v)):
        for f in dataclasses.fields(want):
            a, b = getattr(want, f.name), getattr(got, f.name)
            if a is None:
                assert b is None, f.name
            else:
                np.testing.assert_array_equal(np.asarray(b), a)


def test_profiling_helpers(tmp_path):
    x = torch.ones(64, 64, dtype=torch.float64)
    assert profiling.time_fn(lambda a: a @ a, x, iters=3) > 0
    with profiling.trace(tmp_path) as prof:
        x @ x
    assert (tmp_path / "trace.json").exists()
    assert any("mm" in e.key for e in prof.key_averages())
