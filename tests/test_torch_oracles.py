"""The port's oracles (``baselines.scipy_ref``: SLSQP, EVaR's log-sum-exp
epigraph; ``baselines.admm_ref``: sparse conic ADMM) against the JAX
package's own on the same problem, at 1e-8: numpy and scipy both sides, on
the small problems of tests/test_admm_ref.py."""

import dataclasses

import numpy as np
import pytest

from spock_tpu import risks as jrisks
from spock_tpu.baselines import admm_ref as jadmm
from spock_tpu.baselines import scipy_ref as jscipy
from spock_tpu.models import server_heat as jsh
from spock_tpu_torch.baselines import admm_ref, scipy_ref
from tests.torch_parity import port_spec


def _problem(name):
    """(JAX spec, x0) of test_admm_ref.py's AV@R and TV problems, and
    test_evar.py's EVaR problem."""
    if name == "avar":
        return jsh.make_spec(N=4, nx=3, d=2), np.array([0.4, -0.2, 0.1])
    if name == "tv":
        spec = jsh.make_spec(N=3, nx=4, d=3)
        risk = jrisks.total_variation(np.array([0.2, 0.5, 0.3]), 0.4,
                                      spec.tree.n_nonleaf)
        return (dataclasses.replace(spec, risk=risk),
                np.array([0.3, -0.4, 0.2, 0.5]))
    spec = jsh.make_spec(N=3, nx=2, d=2)
    risk = jrisks.evar(np.array([0.3, 0.7]), 0.7, spec.tree.n_nonleaf)
    return dataclasses.replace(spec, risk=risk), np.array([0.5, -0.4])


@pytest.mark.parametrize("oracle,name", [("scipy", "avar"), ("scipy", "evar"),
                                         ("admm", "avar"), ("admm", "tv")])
def test_oracle_matches_jax_oracle(oracle, name):
    jspec, x0 = _problem(name)
    pspec = port_spec(jspec)
    if oracle == "scipy":
        ref, got = jscipy.solve(jspec, x0), scipy_ref.solve(pspec, x0)
    else:
        kw = dict(tol=1e-9, max_iter=60000)
        ref, got = jadmm.solve(jspec, x0, **kw), admm_ref.solve(pspec, x0,
                                                                **kw)
        assert got["converged"] and got["iterations"] == ref["iterations"]
    keys = [k for k in ("x", "u", "s", "tau", "y", "t", "objective")
            if k in ref]
    assert keys == [k for k in ("x", "u", "s", "tau", "y", "t", "objective")
                    if k in got]
    for k in keys:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-8, err_msg=k)
