"""Helpers of the parity tests between the JAX package and its PyTorch port:
the same inputs, made with numpy from a seed, go to both packages."""

import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spock_tpu import build as jbuild
from spock_tpu import problem as jproblem
from spock_tpu import risks as jrisks
from spock_tpu import zv as jzv
from spock_tpu.models import car as jcar
from spock_tpu.models import server_heat as jsh
from spock_tpu_torch import interop, problem, risks
from spock_tpu_torch.tree import UniformTree


@pytest.fixture(scope="module", autouse=True)
def release_jax_executables():
    """Drops the XLA executables a test module compiled once it is done
    (a module imports this fixture to use it).  Each XLA:CPU executable
    holds memory mappings of its own, and a test worker that runs many JAX
    files can reach the kernel's limit of 65,530 mappings a process
    (vm.max_map_count), where XLA aborts."""
    yield
    jax.clear_caches()
    gc.collect()


def _poly(spec):
    """server_heat N=3 nx=3 with the two-sided polytope of
    tests/test_polytope.py."""
    return dataclasses.replace(spec, polytope=jproblem.Polytope(
        Gx=np.array([[1.0, 1.0, 1.0], [1.0, -1.0, 0.0]]),
        Gu=np.array([[0.0, 0.0, 0.0], [0.5, 0.0, 0.0]]),
        lo=np.array([-1.2, -0.8]), hi=np.array([1.2, 0.8]),
        GxN=np.ones((1, 3)), loN=np.array([-1.0]), hiN=np.array([1.0])))


def _poly_n4(spec):
    """server_heat N=4 nx=4 with the polytope of
    tests/test_pallas_sweep.py's polytope test."""
    Gx = np.array([[1.0, 0.5, 0.0, 0.0], [0.0, 0.0, 1.0, -0.3]])
    return dataclasses.replace(spec, polytope=jproblem.Polytope(
        Gx=Gx, Gu=np.array([[0.2, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.1]]),
        lo=np.array([-1.5, -1.0]), hi=np.array([1.5, 1.0]), GxN=Gx[:1],
        loN=np.array([-1.2]), hiN=np.array([1.2])))


def _navar(spec):
    """Per-node AV@R as in tests/test_risks.py's nonuniform test."""
    rng = np.random.default_rng(3)
    n_nl = spec.tree.n_nonleaf
    ps = np.stack([jrisks.rand_probvec(rng, 2) for _ in range(n_nl)])
    return dataclasses.replace(spec, risk=jrisks.avar_nonuniform(
        ps, rng.uniform(0.4, 0.95, n_nl)))


def _pncost(spec):
    """Per-node costs by the spd() recipe of tests/test_pallas_sweep.py's
    per-node cost test (seed 31)."""
    t, nx = spec.tree, spec.dynamics.A.shape[-1]
    rng = np.random.default_rng(31)

    def spd(n_nodes, base):
        out = base * rng.uniform(0.5, 2.0, (n_nodes, 1, 1)) * np.eye(nx)
        out = out + rng.uniform(-0.02, 0.02, (n_nodes, nx, nx))
        return 0.5 * (out + out.transpose(0, 2, 1)) + 0.1 * np.eye(nx)

    return dataclasses.replace(spec, cost=jproblem.Cost(
        Q=spd(t.n - 1, 0.1), R=spd(t.n - 1, 1.0), QN=spd(t.n_leaf, 0.1)))


SMALL = {
    "car": lambda: jcar.make_spec(N=3, d=2),
    "server_heat": lambda: jsh.make_spec(N=4, nx=5, d=2),
    "server_heat_d3": lambda: jsh.make_spec(N=3, nx=3, d=3),
    # the wider problem class: two-sided polytope rows, per-node risk,
    # per-node costs, and all three at once
    "poly": lambda: _poly(jsh.make_spec(N=3, nx=3, d=2)),
    "poly_n4": lambda: _poly_n4(jsh.make_spec(N=4, nx=4, d=2)),
    "navar": lambda: _navar(jsh.make_spec(N=3, nx=3, d=2)),
    "poly_navar": lambda: _navar(_poly(jsh.make_spec(N=3, nx=3, d=2))),
    "pncost": lambda: _pncost(jsh.make_spec(N=4, nx=4, d=2)),
    "wide": lambda: _pncost(_navar(_poly_n4(jsh.make_spec(N=4, nx=4, d=2)))),
}


def port_spec(spec):
    """The port's Spec with the arrays of a JAX package Spec."""
    poly = spec.polytope
    return problem.Spec(
        tree=UniformTree(N=spec.tree.N, d=spec.tree.d),
        cost=problem.Cost(Q=spec.cost.Q, R=spec.cost.R, QN=spec.cost.QN),
        dynamics=problem.Dynamics(A=spec.dynamics.A, B=spec.dynamics.B),
        risk=risks.RiskSpec(E=spec.risk.E, F=spec.risk.F, b=spec.risk.b,
                            cone=spec.risk.cone),
        constraints=problem.Box(*(getattr(spec.constraints, f) for f in (
            "x_min", "x_max", "u_min", "u_max"))),
        polytope=None if poly is None else problem.Polytope(
            **{f.name: getattr(poly, f.name)
               for f in dataclasses.fields(problem.Polytope)}))


def jax_problem(name):
    """(spec, data, meta) of a small problem, JAX build in float64."""
    spec = SMALL[name]()
    data, meta = jbuild(spec, dtype=jnp.float64)
    return spec, data, meta


def port_data(jdata, jmeta):
    """The port's (data, meta) carried across from the JAX build."""
    meta = interop.meta_from(jmeta)
    arrays = jax.tree_util.tree_map(np.asarray, jdata)
    return interop.problem_data_from_numpy(arrays, meta, device="cpu"), meta


def primal_shapes(meta):
    t = meta.tree
    return dict(x=(meta.nx, t.n), u=(meta.nu, t.n_nonleaf), s=(t.n,),
                tau=(t.n - 1,), y=(meta.ny, t.n_nonleaf))


def dual_shapes(meta):
    t = meta.tree
    return dict(
        y=(meta.ny, t.n_nonleaf), sby=(t.n_nonleaf,), qx=(meta.nx, t.n - 1),
        ru=(meta.nu, t.n - 1), t5=(t.n - 1,), t6=(t.n - 1,),
        cx=(meta.nx, t.n_nonleaf), cu=(meta.nu, t.n_nonleaf),
        qNx=(meta.nx, t.n_leaf), s12=(t.n_leaf,), s13=(t.n_leaf,),
        cxN=(meta.nx, t.n_leaf),
        **({"pnl": (meta.nc_nl, t.n_nonleaf)} if meta.nc_nl else {}),
        **({"plf": (meta.nc_lf, t.n_leaf)} if meta.nc_lf else {}),
    )


def rand_pair(rng, meta, batch=()):
    """Random (Primal, Dual) with numpy leaves (JAX dataclasses)."""
    z = jzv.Primal(**{k: rng.standard_normal(batch + s)
                      for k, s in primal_shapes(meta).items()})
    v = jzv.Dual(**{k: rng.standard_normal(batch + s)
                    for k, s in dual_shapes(meta).items()})
    return z, v


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def to_port(tree):
    """JAX-layout tree with numpy/JAX leaves -> the port's tree (float64
    CPU tensors); tuples and Primal/Dual are walked."""
    if isinstance(tree, tuple):
        return tuple(to_port(t) for t in tree)
    if isinstance(tree, jzv.Primal):
        return interop.primal_from_numpy(tree, device="cpu")
    if isinstance(tree, jzv.Dual):
        return interop.dual_from_numpy(tree, device="cpu")
    return torch.tensor(np.array(tree))


def assert_close(port, ref, atol, rtol=0.0, path="tree"):
    """Leafwise comparison of a port tree with a JAX tree (same field names
    and tuple structure)."""
    if ref is None:
        assert port is None, path
        return
    if isinstance(ref, (tuple, list)):
        assert len(port) == len(ref), path
        for i, (p, r) in enumerate(zip(port, ref)):
            assert_close(p, r, atol, rtol, f"{path}[{i}]")
        return
    if dataclasses.is_dataclass(ref):
        for fl in dataclasses.fields(ref):
            assert_close(getattr(port, fl.name), getattr(ref, fl.name), atol,
                         rtol, f"{path}.{fl.name}")
        return
    got = np.asarray(port.detach().cpu().numpy() if torch.is_tensor(port)
                     else port)
    ref = np.asarray(ref)
    if ref.dtype.kind in "biu":  # flags and counters agree exactly
        np.testing.assert_array_equal(got, ref, err_msg=path)
        return
    np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol, err_msg=path)

