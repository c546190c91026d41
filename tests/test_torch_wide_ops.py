"""The wider problem class (two-sided polytope rows, per-node risk, per-node
costs) through the port's build, operators and whole-sweep functions against
the JAX package's, float64 on the CPU, on the same random inputs.  The sweep
functions are held against the JAX package's Pallas sweep kernels in
interpret mode, as tests/test_pallas_sweep.py holds those against its plain
path; on the CPU the port's wrappers take their plain versions."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spock_tpu import build as jbuild
from spock_tpu import risks as jrisks
from spock_tpu.ops import linop as jlinop
from spock_tpu.ops import pallas_spstep, pallas_sweep
from spock_tpu.ops import prox as jprox
from spock_tpu_torch import build, interop, risks
from spock_tpu_torch.ops import linop, prox, spstep, sweep_kernels
from spock_tpu_torch.problem import RICCATI_FIELDS, ProblemData
from tests.torch_parity import (
    SMALL, assert_close, port_data, port_spec, rand_pair, to_jax, to_port)
from tests.torch_parity import release_jax_executables  # noqa: F401

torch.set_num_threads(1)

GAMMA, SIGMA = 0.2, 0.25
B = 3
# tests/test_pallas_sweep.py's tolerances for these classes
ATOL = {"navar": 1e-9, "poly_n4": 1e-10, "pncost": 1e-10, "wide": 1e-9}


@pytest.fixture(scope="module", params=["poly", "navar", "pncost", "wide"])
def built(request):
    """(name, spec, JAX data/meta, the port's own build) in float64."""
    spec = SMALL[request.param]()
    jdata, jmeta = jbuild(spec, dtype=jnp.float64)
    pdata, pmeta = build(port_spec(spec), dtype=torch.float64, device="cpu")
    return request.param, jdata, jmeta, pdata, pmeta


def test_build_matches_jax(built):
    """Every array of the port's build, the per-node cost and risk arrays
    and the polytope constants included, and ||L||^2."""
    name, jdata, jmeta, pdata, pmeta = built
    assert pmeta == interop.meta_from(jmeta)
    assert (pmeta.nz, pmeta.nv) == (jmeta.nz, jmeta.nv)
    for fl in dataclasses.fields(ProblemData):
        if fl.name in ("ric", "L_sq"):
            continue
        assert_close(getattr(pdata, fl.name), getattr(jdata, fl.name),
                     atol=1e-12, path=fl.name)
    for f in RICCATI_FIELDS:
        assert_close(getattr(pdata.ric, f), getattr(jdata.ric, f),
                     atol=1e-12, path=f"ric.{f}")
    np.testing.assert_allclose(float(pdata.L_sq), float(jdata.L_sq),
                               rtol=1e-10)
    t = pmeta.tree
    if name in ("navar", "wide"):
        assert pdata.b.shape[0] == pdata.ker_proj.shape[0] == t.n_nonleaf
    if name in ("pncost", "wide"):
        assert pdata.sqrtQ.shape[0] == pdata.sqrtR.shape[0] == t.n - 1
        assert pdata.sqrtQN.shape[0] == t.n_leaf
    if name in ("poly", "wide"):
        assert pmeta.nc_nl == 2 and pmeta.nc_lf == 1


def test_avar_nonuniform_matches_jax():
    rng = np.random.default_rng(5)
    ps, alphas = rng.dirichlet(np.ones(3), 4), rng.uniform(0.7, 0.99, 4)
    pr, jr = risks.avar_nonuniform(ps, alphas), jrisks.avar_nonuniform(
        ps, alphas)
    for f in ("E", "F", "b"):
        np.testing.assert_array_equal(getattr(pr, f), getattr(jr, f))
    assert pr.cone == jr.cone


OPS = {
    "apply_L": (lambda d, m, z, v: jlinop.apply_L(d, m, z),
                lambda d, m, z, v: linop.apply_L(d, m, z)),
    "apply_LT": (lambda d, m, z, v: jlinop.apply_LT(d, m, v),
                 lambda d, m, z, v: linop.apply_LT(d, m, v)),
    "metric_apply": (
        lambda d, m, z, v: jlinop.metric_apply(d, m, z, v, GAMMA, SIGMA),
        lambda d, m, z, v: linop.metric_apply(d, m, z, v, GAMMA, SIGMA)),
    "prox_h_conj": (lambda d, m, z, v: jprox.prox_h_conj(d, m, v, SIGMA),
                    lambda d, m, z, v: prox.prox_h_conj(d, m, v, SIGMA)),
    "project_risk_kernel": (
        lambda d, m, z, v: jprox.project_risk_kernel(d, m, z.s[..., 1:],
                                                     z.tau, z.y),
        lambda d, m, z, v: prox.project_risk_kernel(d, m, z.s[..., 1:],
                                                    z.tau, z.y)),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_op_matches_jax(built, op):
    """The eager operators on the wider class, batched, at 1e-12."""
    _, jdata, jmeta, pdata, pmeta = built
    z, v = rand_pair(np.random.default_rng(sorted(OPS).index(op)), jmeta,
                     batch=(B,))
    jop, pop = OPS[op]
    ref = jop(jdata, jmeta, to_jax(z), to_jax(v))
    got = pop(pdata, pmeta, to_port(z), to_port(v))
    assert_close(got, ref, atol=1e-12, path=op)


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


def kernel_problem_of(problem):
    """A problem of the class of the JAX sweep kernels, carried across."""
    jdata, jmeta = jbuild(SMALL[problem](), dtype=jnp.float64)
    pdata, pmeta = port_data(jdata, jmeta)
    assert pallas_sweep.supported(jmeta, jdata)
    assert sweep_kernels.supported(pmeta, pdata)
    return problem, jdata, jmeta, pdata, pmeta


# the other two classes are in tests/test_torch_wide_sweep.py, so that each
# file stays short alone
@pytest.fixture(scope="module", params=["navar", "wide"])
def kernel_problem(request):
    return kernel_problem_of(request.param)


def fused_parity(kernel_problem, name):
    """The port's fused function (plain route on the CPU) against the JAX
    Pallas kernel in interpret mode, with the tolerances of
    tests/test_pallas_sweep.py: 1e-9 on per-node risk, 1e-10 on polytopes
    and per-node costs."""
    problem, jdata, jmeta, pdata, pmeta = kernel_problem
    rng = np.random.default_rng(7)
    z, v = rand_pair(rng, jmeta, batch=(B,))
    dz, dv = rand_pair(rng, jmeta, batch=(B,))
    x0 = rng.uniform(-0.5, 0.5, (B, jmeta.nx))
    tau = rng.uniform(0.3, 1.0, B)
    call = CALLS[name]
    ref = call(getattr(pallas_sweep, name), jdata, jmeta, to_jax(z),
               to_jax(v), to_jax(dz), to_jax(dv), jnp.asarray(x0),
               jnp.asarray(tau), interpret=True)
    before = dict(sweep_kernels.LAUNCHES)
    got = call(getattr(sweep_kernels, name), pdata, pmeta, to_port(z),
               to_port(v), to_port(dz), to_port(dv), to_port(x0),
               to_port(tau))
    assert sweep_kernels.LAUNCHES == before  # CPU tensors: no launch
    assert_close(got, ref, atol=ATOL[problem])


@pytest.mark.parametrize("name", list(CALLS))
def test_fused_function_matches_jax_kernel(kernel_problem, name):
    fused_parity(kernel_problem, name)


def support_parity(kernel_problem):
    """sweep_kernels.supported and spstep.supported accept what
    pallas_sweep.supported and pallas_spstep.supported accept: the step
    rejects per-node costs, the sweeps take them; a second-order risk cone
    is rejected by both packages."""
    problem, jdata, jmeta, pdata, pmeta = kernel_problem
    assert sweep_kernels.supported(pmeta, pdata)
    assert spstep.supported(pmeta, pdata) == pallas_spstep.supported(
        jmeta, jdata)
    assert spstep.supported(pmeta, pdata) == (problem not in ("pncost",
                                                              "wide"))
    soc = (("soc", jmeta.ny),)
    assert not pallas_sweep.supported(dataclasses.replace(jmeta, cone=soc),
                                      jdata)
    assert not sweep_kernels.supported(dataclasses.replace(pmeta, cone=soc),
                                       pdata)
    assert not spstep.supported(dataclasses.replace(pmeta, cone=soc), pdata)


def test_support_matches_jax_in_both_directions(kernel_problem):
    support_parity(kernel_problem)
