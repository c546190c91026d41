"""The port's offline build, tree, risks and interop against the JAX package
(float64, CPU)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from spock_tpu import risks as jrisks
from spock_tpu.models import car as jcar
from spock_tpu.models import server_heat as jsh
from spock_tpu.tree import UniformTree as JTree
from spock_tpu_torch import build, interop, risks
from spock_tpu_torch.models import car, server_heat
from spock_tpu_torch.problem import RICCATI_FIELDS, ProblemData
from spock_tpu_torch.tree import UniformTree
from tests.torch_parity import assert_close, rand_pair
from tests.torch_parity import release_jax_executables  # noqa: F401

torch.set_num_threads(1)

PORT_SPECS = {
    "car": lambda: car.make_spec(N=3, d=2),
    "server_heat": lambda: server_heat.make_spec(N=4, nx=5, d=2),
}
JAX_SPECS = {
    "car": lambda: jcar.make_spec(N=3, d=2),
    "server_heat": lambda: jsh.make_spec(N=4, nx=5, d=2),
}


@pytest.fixture(scope="module", params=["car", "server_heat"])
def both(request):
    import jax.numpy as jnp

    from spock_tpu import build as jbuild

    jdata, jmeta = jbuild(JAX_SPECS[request.param](), dtype=jnp.float64)
    pdata, pmeta = build(PORT_SPECS[request.param](), dtype=torch.float64,
                         device="cpu")
    return jdata, jmeta, pdata, pmeta


def test_build_matches_jax(both):
    """Every array of the build, the Riccati factors and ker_proj included."""
    jdata, _, pdata, _ = both
    for fl in dataclasses.fields(ProblemData):
        if fl.name in ("ric", "L_sq"):
            continue
        assert_close(getattr(pdata, fl.name), getattr(jdata, fl.name),
                     atol=1e-12, path=fl.name)
    for f in RICCATI_FIELDS:
        assert_close(getattr(pdata.ric, f), getattr(jdata.ric, f), atol=1e-12,
                     path=f"ric.{f}")


def test_L_sq_matches_jax(both):
    """The power iteration from the same rng gives the same ||L||^2."""
    jdata, _, pdata, _ = both
    np.testing.assert_allclose(float(pdata.L_sq), float(jdata.L_sq),
                               rtol=1e-10)


def test_sizes(both):
    """nz/nv and the static metadata equal the JAX package's."""
    _, jmeta, _, pmeta = both
    assert pmeta == interop.meta_from(jmeta)
    assert (pmeta.nz, pmeta.nv) == (jmeta.nz, jmeta.nv)
    t = pmeta.tree
    assert pmeta.nz == (t.n * pmeta.nx + t.n_nonleaf * pmeta.nu + t.n
                        + (t.n - 1) + t.n_nonleaf * pmeta.ny)
    if pmeta.nx == 2:  # car N=3, d=2: z blocks 14/3/7/6/15
        assert pmeta.nz == 14 + 3 + 7 + 6 + 15


@pytest.mark.parametrize("N,d", [(4, 2), (3, 3), (5, 2)])
def test_tree_maps_match_jax(N, d):
    """Sibling-major parent, children and realization index of every node."""
    pt, jt = UniformTree(N=N, d=d), JTree(N=N, d=d)
    assert (pt.n, pt.n_leaf, pt.n_nonleaf) == (jt.n, jt.n_leaf, jt.n_nonleaf)
    for j in range(1, pt.n):
        assert (pt.parent(j), pt.w(j)) == (jt.parent(j), jt.w(j))
    for i in range(pt.n_nonleaf):
        assert pt.children(i) == jt.children(i)
        assert all(pt.parent(c) == i for c in pt.children(i))


def test_risks_match_jax():
    p = np.array([0.2, 0.5, 0.3])
    pairs = [
        (risks.avar(p, 0.7, 4), jrisks.avar(p, 0.7, 4)),
        (risks.total_variation(p, 0.4, 4), jrisks.total_variation(p, 0.4, 4)),
        (risks.risk_neutral(p, 4), jrisks.risk_neutral(p, 4)),
    ]
    for pr, jr in pairs:
        for f in ("E", "F", "b"):
            np.testing.assert_array_equal(getattr(pr, f), getattr(jr, f))
        assert pr.cone == jr.cone
        assert risks.dual_cone(pr.cone) == jrisks.dual_cone(jr.cone)
        assert risks.cone_dim(pr.cone) == jrisks.cone_dim(jr.cone) == pr.ny
    np.testing.assert_array_equal(
        risks.rand_probvec(np.random.default_rng(3), 4),
        jrisks.rand_probvec(np.random.default_rng(3), 4))


def test_interop_round_trip_is_exact(both):
    jdata, jmeta, _, pmeta = both
    arrays = jax.tree_util.tree_map(np.asarray, jdata)
    pdata = interop.problem_data_from_numpy(arrays, pmeta, device="cpu")
    assert_close(pdata, jdata, atol=0.0)
    # ric handed over as nested tuples instead of a dataclass
    ric_tuples = tuple(getattr(arrays.ric, f) for f in RICCATI_FIELDS)
    pdata2 = interop.problem_data_from_numpy(
        dataclasses.replace(arrays, ric=ric_tuples), pmeta, device="cpu")
    assert_close(pdata2.ric, jdata.ric, atol=0.0)
    z, v = rand_pair(np.random.default_rng(0), jmeta, batch=(2,))
    assert_close(interop.primal_from_numpy(z, device="cpu"), z, atol=0.0)
    assert_close(interop.dual_from_numpy(v, device="cpu"), v, atol=0.0)
    assert pdata.dtype == torch.float64 and pdata.device.type == "cpu"
