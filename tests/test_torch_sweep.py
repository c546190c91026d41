"""The port's whole-sweep functions (ops/sweep_kernels.py) against the JAX
package's Pallas sweep kernels (spock_tpu/ops/pallas_sweep.py, interpret
mode), float64 on the CPU, where the port's wrappers take their plain
versions.  The CUDA kernels themselves are held against the plain versions
on the card (tests/test_torch_isolation.py, chip_smoke.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spock_tpu.ops import pallas_sweep
from spock_tpu_torch.ops import sweep_kernels
from tests.torch_parity import (
    assert_close, jax_problem, port_data, rand_pair, to_jax, to_port)

torch.set_num_threads(1)

GAMMA, SIGMA = 0.3, 0.25
B = 3
ATOL = 1e-10  # tests/test_pallas_sweep.py's tolerance


@pytest.fixture(scope="module", params=["server_heat", "server_heat_d3"])
def problem(request):
    _, jdata, jmeta = jax_problem(request.param)
    pdata, pmeta = port_data(jdata, jmeta)
    assert pallas_sweep.supported(jmeta, jdata)
    assert sweep_kernels.supported(pmeta, pdata)
    return jdata, jmeta, pdata, pmeta


def _inputs(jmeta, seed):
    rng = np.random.default_rng(seed)
    z, v = rand_pair(rng, jmeta, batch=(B,))
    dz, dv = rand_pair(rng, jmeta, batch=(B,))
    x0 = rng.standard_normal((B, jmeta.nx))
    tau = rng.random(B)
    return z, v, dz, dv, x0, tau


CALLS = {
    "cp_sweep_fused": lambda f, d, m, z, v, dz, dv, x0, tau, **kw: f(
        d, m, z, v, GAMMA, SIGMA, x0, **kw),
    "cp_sweep_metric_fused": lambda f, d, m, z, v, dz, dv, x0, tau, **kw: f(
        d, m, z, v, GAMMA, SIGMA, x0, **kw),
    "candidate_sweep_fused": lambda f, d, m, z, v, dz, dv, x0, tau, **kw: f(
        d, m, z, v, dz, dv, tau, GAMMA, SIGMA, x0, **kw),
    "metric_apply_fused": lambda f, d, m, z, v, dz, dv, x0, tau, **kw: f(
        d, m, z, v, GAMMA, SIGMA, **kw),
}


@pytest.mark.parametrize("name", list(CALLS))
def test_fused_function_matches_jax(problem, name):
    """The port's fused function (plain route on the CPU) against the JAX
    Pallas kernel in interpret mode, same signature and return tuple."""
    jdata, jmeta, pdata, pmeta = problem
    z, v, dz, dv, x0, tau = _inputs(jmeta, 7)
    call = CALLS[name]
    ref = call(getattr(pallas_sweep, name), jdata, jmeta, to_jax(z),
               to_jax(v), to_jax(dz), to_jax(dv), jnp.asarray(x0),
               jnp.asarray(tau), interpret=True)
    before = dict(sweep_kernels.LAUNCHES)
    got = call(getattr(sweep_kernels, name), pdata, pmeta, to_port(z),
               to_port(v), to_port(dz), to_port(dv), to_port(x0),
               to_port(tau))
    assert sweep_kernels.LAUNCHES == before  # CPU tensors: no launch
    assert_close(got, ref, atol=ATOL)


def test_support_follows_the_problem_class(problem):
    """The JAX sweep kernels' class: costs and risk uniform or per node,
    with or without polytope rows, are supported; a second-order risk cone
    is not (the composed path takes that)."""
    _, _, pdata, pmeta = problem
    t = pmeta.tree
    assert sweep_kernels.supported(pmeta, pdata)

    def per_node(a, k):
        return a.expand((k,) + tuple(a.shape[1:])).contiguous()

    cases = {
        "sqrtQ": dataclasses.replace(pdata, sqrtQ=per_node(pdata.sqrtQ,
                                                           t.n - 1)),
        "sqrtR": dataclasses.replace(pdata, sqrtR=per_node(pdata.sqrtR,
                                                           t.n - 1)),
        "sqrtQN": dataclasses.replace(pdata, sqrtQN=per_node(pdata.sqrtQN,
                                                             t.n_leaf)),
        "risk": dataclasses.replace(
            pdata, b=per_node(pdata.b, t.n_nonleaf),
            ker_proj=per_node(pdata.ker_proj, t.n_nonleaf)),
    }
    for name, data in cases.items():
        assert sweep_kernels.supported(pmeta, data), name
    assert sweep_kernels.supported(
        dataclasses.replace(pmeta, nc_nl=2), pdata)
    assert not sweep_kernels.supported(
        dataclasses.replace(pmeta, cone=(("soc", pmeta.ny),)), pdata)
    # node dimensions that are neither uniform nor per node
    assert not sweep_kernels.supported(
        pmeta, dataclasses.replace(pdata, sqrtQ=per_node(pdata.sqrtQ, 2)))
    assert not sweep_kernels.supported(
        pmeta, dataclasses.replace(pdata, b=per_node(pdata.b, t.n_nonleaf)))
