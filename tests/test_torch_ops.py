"""The port's operators and the plain path of its kernel module against the
JAX package's, float64 on the CPU, on the same random inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spock_tpu.ops import cones as jcones
from spock_tpu.ops import linop as jlinop
from spock_tpu.ops import pallas_kernels
from spock_tpu.ops import prox as jprox
from spock_tpu.ops import riccati as jriccati
from spock_tpu_torch import zv
from spock_tpu_torch.ops import cones, cuda_kernels, linop, prox, riccati
from tests.torch_parity import (
    assert_close, jax_problem, port_data, rand_pair, to_jax, to_port)
from tests.torch_parity import release_jax_executables  # noqa: F401

torch.set_num_threads(1)

GAMMA, SIGMA = 0.21, 0.37


@pytest.fixture(scope="module", params=["car", "server_heat"])
def problem(request):
    _, jdata, jmeta = jax_problem(request.param)
    pdata, pmeta = port_data(jdata, jmeta)
    return jdata, jmeta, pdata, pmeta


def _inputs(jmeta, seed):
    rng = np.random.default_rng(seed)
    z, v = rand_pair(rng, jmeta, batch=(3,))
    x0 = rng.standard_normal((3, jmeta.nx))
    return z, v, x0


OPS = {
    "apply_L": (lambda d, m, z, v, x0: jlinop.apply_L(d, m, z),
                lambda d, m, z, v, x0: linop.apply_L(d, m, z)),
    "apply_LT": (lambda d, m, z, v, x0: jlinop.apply_LT(d, m, v),
                 lambda d, m, z, v, x0: linop.apply_LT(d, m, v)),
    "metric_apply": (
        lambda d, m, z, v, x0: jlinop.metric_apply(d, m, z, v, GAMMA, SIGMA),
        lambda d, m, z, v, x0: linop.metric_apply(d, m, z, v, GAMMA, SIGMA)),
    "project_dynamics": (
        lambda d, m, z, v, x0: jriccati.project_dynamics(d, m, z.x, z.u, x0),
        lambda d, m, z, v, x0: riccati.project_dynamics(d, m, z.x, z.u, x0)),
    "project_risk_kernel": (
        lambda d, m, z, v, x0: jprox.project_risk_kernel(
            d, m, z.s[..., 1:], z.tau, z.y),
        lambda d, m, z, v, x0: prox.project_risk_kernel(
            d, m, z.s[..., 1:], z.tau, z.y)),
    "prox_f": (lambda d, m, z, v, x0: jprox.prox_f(d, m, z, GAMMA, x0),
               lambda d, m, z, v, x0: prox.prox_f(d, m, z, GAMMA, x0)),
    "prox_h_conj": (lambda d, m, z, v, x0: jprox.prox_h_conj(d, m, v, SIGMA),
                    lambda d, m, z, v, x0: prox.prox_h_conj(d, m, v, SIGMA)),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_op_matches_jax(problem, op):
    jdata, jmeta, pdata, pmeta = problem
    z, v, x0 = _inputs(jmeta, seed=sorted(OPS).index(op))
    jop, pop = OPS[op]
    ref = jop(jdata, jmeta, to_jax(z), to_jax(v), jnp.asarray(x0))
    got = pop(pdata, pmeta, to_port(z), to_port(v), to_port(x0))
    assert_close(got, ref, atol=1e-12, path=op)


def test_adjointness(problem):
    """<L z, v> == <z, L' v> in the port."""
    _, jmeta, pdata, pmeta = problem
    rng = np.random.default_rng(1)
    for _ in range(3):
        z, v = rand_pair(rng, jmeta)
        z, v = to_port(z), to_port(v)
        lhs = zv.vdot(linop.apply_L(pdata, pmeta, z), v)
        rhs = zv.vdot(z, linop.apply_LT(pdata, pmeta, v))
        np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-10)


def test_kernel_module_plain_path_matches_pallas(problem):
    """cuda_kernels.prox_h_conj_fused on CPU tensors (its plain version)
    against the Pallas kernel in interpret mode; no launch is counted."""
    jdata, jmeta, pdata, pmeta = problem
    assert cuda_kernels.supported(pmeta) == pallas_kernels.supported(jmeta)
    _, v, _ = _inputs(jmeta, seed=11)
    ref = pallas_kernels.prox_h_conj_fused(jdata, jmeta, to_jax(v), SIGMA,
                                           interpret=True)
    before = cuda_kernels.LAUNCHES
    got = cuda_kernels.prox_h_conj_fused(pdata, pmeta, to_port(v), SIGMA)
    assert cuda_kernels.LAUNCHES == before
    assert_close(got, ref, atol=1e-12, path="prox_h_conj_fused")


def test_cone_projections_match_jax():
    """SOC and product-cone projections (polyhedral and SOC segments)."""
    rng = np.random.default_rng(5)
    v = rng.standard_normal((2, 7, 9))
    assert_close(cones.project_soc(torch.tensor(v)),
                 jcones.project_soc(jnp.asarray(v)), atol=1e-12)
    spec = (("nonneg", 2), ("soc", 3), ("zero", 1), ("nonpos", 1),
            ("reals", 0))
    assert_close(cones.project_cone_product(torch.tensor(v), spec),
                 jcones.project_cone_product(jnp.asarray(v), spec),
                 atol=1e-12)
    lo, hi = -rng.random(7), rng.random(7)
    assert_close(cones.project_box(torch.tensor(v), torch.tensor(lo),
                                   torch.tensor(hi)),
                 jcones.project_box(jnp.asarray(v), lo, hi), atol=0.0)
