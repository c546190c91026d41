"""Helpers of the parity tests between the JAX package and its PyTorch port:
the same inputs, made with numpy from a seed, go to both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from spock_tpu import build as jbuild
from spock_tpu import zv as jzv
from spock_tpu.models import car as jcar
from spock_tpu.models import server_heat as jsh
from spock_tpu_torch import interop

SMALL = {
    "car": lambda m: m.make_spec(N=3, d=2),
    "server_heat": lambda m: m.make_spec(N=4, nx=5, d=2),
}


def jax_problem(name):
    """(spec, data, meta) of a small problem, JAX build in float64."""
    spec = SMALL[name]({"car": jcar, "server_heat": jsh}[name])
    data, meta = jbuild(spec, dtype=jnp.float64)
    return spec, data, meta


def port_data(jdata, jmeta):
    """The port's (data, meta) carried across from the JAX build."""
    meta = interop.meta_from(jmeta)
    arrays = jax.tree_util.tree_map(np.asarray, jdata)
    return interop.problem_data_from_numpy(arrays, meta), meta


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
        return interop.primal_from_numpy(tree)
    if isinstance(tree, jzv.Dual):
        return interop.dual_from_numpy(tree)
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

