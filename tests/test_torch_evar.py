"""EVaR in the port: the exponential-cone projection, the EVaR build and a
CP sweep held against the JAX package (float64, CPU), an EVaR solve held
against the port's scipy oracle, the mean <= EVaR <= worst-case ordering,
and the path a Solver takes for it (the plain one, chosen by class)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spock_tpu import build as jbuild
from spock_tpu import risks as jrisks
from spock_tpu.algorithms import common as jcommon
from spock_tpu.models import server_heat as jsh
from spock_tpu.ops.cones import _project_exp_cone as jproject_exp
from spock_tpu_torch import build, risks
from spock_tpu_torch.algorithms import common
from spock_tpu_torch.algorithms import supermann as sp
from spock_tpu_torch.baselines import scipy_ref
from spock_tpu_torch.models import server_heat
from spock_tpu_torch.ops import cuda_kernels, spstep, sweep_kernels
from spock_tpu_torch.ops.cones import _project_exp_cone
from spock_tpu_torch.solver import Solver
from tests.torch_parity import (
    assert_close, port_data, port_spec, rand_pair, to_jax, to_port)
from tests.torch_parity import release_jax_executables  # noqa: F401

torch.set_num_threads(1)

# test_evar.py's branch points: interior, interior, face, face, polar
BRANCH_POINTS = [[0.0, 1.0, 2.0], [-1.0, 0.5, 3.0], [-2.531, -1.247, 0.083],
                 [-4.65, -0.438, -2.492], [2.0, 0.1, -3.0]]
# After its 40 golden-section steps the boundary solve has located the
# minimising a only to the last bracket, 0.618^40 (~4.4e-9) of a grid
# interval wide, and the last comparisons d1 < d2 are decided by rounding:
# XLA's exp and torch's differ in the last bit on many arguments, so a point
# found by that solve moves within the bracket while its distance to v,
# flat at the minimum, agrees to rounding.  Every other case
# (inside, polar, face) and every distance is held at 1e-12.
EXACT = 1e-12
BRACKET = 1e-7


def _boundary_columns(v):
    """Columns of v [3, n] whose projection comes from the boundary solve:
    neither in the cone, nor in the polar cone, nor on the face."""
    p = _project_exp_cone(torch.tensor(v)).numpy()
    inside = np.all(p == v, axis=0)
    polar = np.all(p == 0.0, axis=0)
    face = (p[1] == 0.0) & (p[0] == v[0])
    return ~(inside | polar | face)


def _hold_projection(v):
    got = _project_exp_cone(torch.tensor(v)).numpy()
    ref = np.asarray(jproject_exp(jnp.asarray(v)))
    bdry = _boundary_columns(v)
    np.testing.assert_allclose(got[:, ~bdry], ref[:, ~bdry], atol=EXACT)
    np.testing.assert_allclose(np.linalg.norm(got - v, axis=0),
                               np.linalg.norm(ref - v, axis=0), atol=EXACT)
    np.testing.assert_allclose(got[:, bdry], ref[:, bdry], atol=BRACKET)
    return bdry


@pytest.mark.parametrize("points", ["branches", "random"])
def test_exp_cone_projection_matches_jax(points):
    if points == "branches":
        v = np.array(BRANCH_POINTS, dtype=np.float64).T
        assert not _hold_projection(v).any()
    else:
        v = np.random.default_rng(1).standard_normal((3, 64)) * 2.0
        assert _hold_projection(v).any()


def test_exp_cone_projection_properties():
    """Idempotence and firm nonexpansiveness (test_evar.py's property
    test, on the port)."""
    rng = np.random.default_rng(1)
    v = torch.tensor(rng.standard_normal((3, 64)) * 2.0)
    p1 = _project_exp_cone(v)
    torch.testing.assert_close(_project_exp_cone(p1), p1, atol=1e-5, rtol=0)
    w = torch.tensor(rng.standard_normal((3, 64)) * 2.0)
    q1 = _project_exp_cone(w)
    lhs = torch.sum((p1 - q1) * (v - w))
    rhs = torch.sum((p1 - q1) ** 2)
    assert float(lhs) >= float(rhs) - 1e-6


def _evar_spec(alpha=0.7):
    spec0 = jsh.make_spec(N=3, nx=2, d=2)
    return dataclasses.replace(spec0, risk=jrisks.evar(
        np.array([0.3, 0.7]), alpha=alpha, n_nonleaf=spec0.tree.n_nonleaf))


def test_evar_risk_matches_jax():
    jr = _evar_spec().risk
    pr = risks.evar(np.array([0.3, 0.7]), alpha=0.7, n_nonleaf=jr.n_nonleaf)
    for f in ("E", "F", "b"):
        np.testing.assert_array_equal(getattr(pr, f), getattr(jr, f))
    assert (pr.cone, pr.kind, pr.params) == (jr.cone, jr.kind, jr.params)
    assert risks.dual_cone(pr.cone) == jrisks.dual_cone(jr.cone)


def test_evar_build_and_sweep_match_jax():
    """The port's own build of EVaR against the JAX build at 1e-12, and one
    plain CP sweep from random (z, v) against JAX's.  The sweep's y block
    ends in the exp-dual projection (Moreau through the boundary solve):
    those rows are held at the bracket's resolution times sigma, every other
    output at 1e-12."""
    jspec = _evar_spec()
    jdata, jmeta = jbuild(jspec, dtype=jnp.float64)
    pdata, pmeta = build(port_spec(jspec), dtype=torch.float64, device="cpu")
    for f in ("ker_proj", "b", "E", "F"):
        np.testing.assert_allclose(getattr(pdata, f).numpy(),
                                   np.asarray(getattr(jdata, f)), atol=EXACT)
    np.testing.assert_allclose(float(pdata.L_sq), float(jdata.L_sq),
                               rtol=1e-10)
    assert pmeta.dual_cone == jmeta.dual_cone
    cdata, cmeta = port_data(jdata, jmeta)
    rng = np.random.default_rng(3)
    B, gamma, sigma = 3, 0.21, 0.37
    z, v = rand_pair(rng, jmeta, batch=(B,))
    x0 = rng.standard_normal((B, jmeta.nx))
    zr, vr = jax.jit(jcommon.cp_sweep, static_argnums=1)(
        jdata, jmeta, to_jax(z), to_jax(v), gamma, sigma, jnp.asarray(x0))
    zg, vg = common.cp_sweep(cdata, cmeta, to_port(z), to_port(v), gamma,
                             sigma, to_port(x0))
    assert_close(zg, zr, atol=EXACT)
    ny_lin = jspec.tree.d + 2  # the rows before the exp-dual segments
    for f in dataclasses.fields(vr):
        if getattr(vr, f.name) is None:
            assert getattr(vg, f.name) is None
            continue
        got, ref = getattr(vg, f.name).numpy(), np.asarray(getattr(vr, f.name))
        if f.name == "y":
            np.testing.assert_allclose(got[:, :ny_lin], ref[:, :ny_lin],
                                       atol=EXACT)
            got, ref = got[:, ny_lin:], ref[:, ny_lin:]
            np.testing.assert_allclose(got, ref, atol=BRACKET * sigma)
        else:
            np.testing.assert_allclose(got, ref, atol=EXACT, err_msg=f.name)


def _port_problem(risk):
    spec = dataclasses.replace(server_heat.make_spec(N=3, nx=2, d=2),
                               risk=risk)
    return spec, build(spec, dtype=torch.float64, device="cpu")


def test_evar_matches_scipy_oracle():
    """test_evar.py's oracle check on the port: the solve against the port's
    own SLSQP oracle (EVaR's log-sum-exp epigraph, no exponential cone)."""
    nnl = server_heat.make_spec(N=3, nx=2, d=2).tree.n_nonleaf
    spec, (data, meta) = _port_problem(
        risks.evar(np.array([0.3, 0.7]), 0.7, nnl))
    x0 = np.array([0.5, -0.4])
    res = Solver(data, meta, algorithm="spock", device="cpu").solve(
        x0, tol=1e-7)
    assert bool(res.converged)
    ora = scipy_ref.solve(spec, x0=x0)
    np.testing.assert_allclose(float(res.z.s[0]), ora["objective"], atol=5e-4)
    np.testing.assert_allclose(res.z.u[:, 0].numpy(), ora["u"][0], atol=5e-4)


def test_evar_between_mean_and_worst_case():
    """risk-neutral <= EVaR_0.2 <= AV@R_0.001 (~ worst case), as
    test_evar.py."""
    p = np.array([0.3, 0.7])
    x0 = np.array([0.5, -0.4])
    nnl = server_heat.make_spec(N=3, nx=2, d=2).tree.n_nonleaf
    objs = {}
    for name, risk in (("neutral", risks.risk_neutral(p, nnl)),
                       ("evar", risks.evar(p, 0.2, nnl)),
                       ("worst", risks.avar(p, 1e-3, nnl))):
        _, (data, meta) = _port_problem(risk)
        res = Solver(data, meta, algorithm="spock", device="cpu").solve(
            x0, tol=1e-7)
        assert bool(res.converged), name
        objs[name] = float(res.z.s[0])
    assert objs["neutral"] <= objs["evar"] + 1e-5
    assert objs["evar"] <= objs["worst"] + 1e-5


def test_evar_solver_takes_the_plain_path(monkeypatch):
    """EVaR's dual cone (exp_dual) lies outside every kernel's class, so a
    Solver with the default flags (fused_sweep and fused_step on) runs the
    composed iteration with the plain prox_h*: no kernel wrapper is called
    at all (each is replaced by one that raises), chosen by class."""
    nnl = server_heat.make_spec(N=3, nx=2, d=2).tree.n_nonleaf
    _, (data, meta) = _port_problem(risks.evar(np.array([0.3, 0.7]), 0.5,
                                               nnl))
    assert not cuda_kernels.supported(meta)
    assert not sweep_kernels.supported(meta, data)
    assert not spstep.supported(meta, data)
    assert not sp.use_fused_step(data, meta, sp.SuperMannOpts())

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called")

    for mod, name in ((cuda_kernels, "prox_h_conj_fused"),
                      (sweep_kernels, "cp_sweep_fused"),
                      (sweep_kernels, "cp_sweep_metric_fused"),
                      (sweep_kernels, "candidate_sweep_fused"),
                      (sweep_kernels, "metric_apply_fused"),
                      (spstep, "sp_step_fused"),
                      (spstep, "sp_step_backtrack")):
        monkeypatch.setattr(mod, name, refuse)
    res = Solver(data, meta, algorithm="spock", device="cpu",
                 max_iter=30).solve(np.array([0.5, -0.4]), tol=1e-4)
    assert res.residuals is None
    assert np.isfinite(float(res.z.s[0]))
