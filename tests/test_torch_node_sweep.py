"""The CP sweep kernels' two bodies (csrc/cp_sweep.cu): which problems take
the node body of csrc/step_body.cuh and which the element body of
csrc/sweep_body.cuh, the node-minor copies of per-node cost matrices that the
node body reads, its shared-memory plan, and on the card both bodies against
the plain versions.

This file imports no JAX, so its card tests also run on a machine without
JAX:  python -m pytest tests/test_torch_node_sweep.py -m cuda --noconftest
-o addopts="" -p no:cacheprovider
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from spock_tpu_torch import build
from spock_tpu_torch.algorithms import common
from spock_tpu_torch.models import server_heat
from spock_tpu_torch.ops import _build, linop, spstep, sweep_kernels
from spock_tpu_torch.zv import leaves

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def headline_specs():
    """The headline server_heat N=10 nx=20 d=2 and chip_smoke.py's two
    wider configurations built from it: _navar (per-node AV@R, polytope
    rows) and _pncost (the same with per-node costs)."""
    spec = server_heat.make_spec(N=10, nx=20, d=2)
    navar, pncost = chip_smoke.wide_specs(spec)
    return {"headline": build(spec, dtype=torch.float64, device="cpu"),
            "navar": build(navar, dtype=torch.float64, device="cpu"),
            "pncost": build(pncost, dtype=torch.float64, device="cpu")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("config", ["headline", "navar", "pncost"])
def test_headline_configurations_take_the_node_body(headline_specs, config,
                                                    dtype):
    data, meta = headline_specs[config]
    assert sweep_kernels.sweep_body(meta, data, dtype) == sweep_kernels.NODE
    plan = sweep_kernels.node_plan(meta, data, torch.finfo(dtype).bits // 8)
    # costates (15,360 values a lane) in shared memory in both value types
    assert plan["costates_in_shared_memory"]
    assert plan["bytes"] <= sweep_kernels.SMEM_LIMIT


def test_node_plan_matches_the_kernels_planner(headline_specs):
    """The mirror reproduces what csrc/step_body.cuh's planner gave on the
    card for the step kernels at the headline size (138,672 bytes a block
    in float32, 226,144 in float64), and per-node costs, which are not
    staged, leave more room."""
    data, meta = headline_specs["headline"]
    assert sweep_kernels.node_plan(meta, data, 4)["bytes"] == 138672
    assert sweep_kernels.node_plan(meta, data, 8)["bytes"] == 226144
    pdata, pmeta = headline_specs["pncost"]
    for itemsize in (4, 8):
        assert (sweep_kernels.node_plan(pmeta, pdata, itemsize)["bytes"]
                < sweep_kernels.node_plan(meta, data, itemsize)["bytes"])


def test_node_body_keeps_costates_in_device_memory_where_they_do_not_fit():
    """server_heat N=11 nx=20 in float64: a lane's 30,720 costate values do
    not fit beside the rest, so the node body keeps them in device memory
    (and the wrapper allocates them); in float32 they fit."""
    data, meta = build(server_heat.make_spec(N=11, nx=20, d=2),
                       dtype=torch.float64, device="cpu")
    assert sweep_kernels.sweep_body(meta, data, torch.float64) == "node"
    assert not sweep_kernels.node_plan(
        meta, data, 8)["costates_in_shared_memory"]
    assert sweep_kernels.node_plan(meta, data, 4)["costates_in_shared_memory"]
    scratch = sweep_kernels._scratch("node", meta, data, 2, torch.float64,
                                     "cpu")
    assert tuple(scratch[0].shape) == (2, meta.tree.n_nonleaf * 20)
    assert tuple(scratch[1].shape) == (2, 30720)
    assert scratch[2:] == [None, None]


@pytest.mark.parametrize("nx, body", [(32, "node"), (33, "element")])
def test_wider_problems_take_the_element_body(nx, body):
    """The node body holds a node's columns in registers: nx, nu and the
    polytope rows of a node are at most 32; wider problems in the sweep
    kernels' class take the element body."""
    data, meta = build(server_heat.make_spec(N=2, nx=nx, d=2),
                       dtype=torch.float64, device="cpu")
    assert sweep_kernels.supported(meta, data)
    for dtype in (torch.float32, torch.float64):
        assert sweep_kernels.sweep_body(meta, data, dtype) == body
    assert (sweep_kernels.node_plan(meta, data, 8) is None) == (
        body == "element")
    # the same bound on the polytope rows of a node
    small, small_meta = build(server_heat.make_spec(N=2, nx=3, d=2),
                              dtype=torch.float64, device="cpu")
    for rows in ("nc_nl", "nc_lf"):
        wide = dataclasses.replace(small_meta, **{rows: nx})
        assert (sweep_kernels.node_plan(wide, small, 8) is None) == (
            body == "element")


def test_body_choice_raises_on_an_unsupported_class():
    data, meta = build(server_heat.make_spec(N=3, nx=3, d=2),
                       dtype=torch.float64, device="cpu")
    meta = dataclasses.replace(meta, cone=(("soc", meta.ny),))
    with pytest.raises(ValueError, match="unsupported problem class"):
        sweep_kernels.sweep_body(meta, data, torch.float64)


def _nonsymmetric_costs(data, meta, seed=3):
    """Per-node cost square roots that are not symmetric, so that a matrix
    read where its transpose belongs shows."""
    t = meta.tree
    rng = np.random.default_rng(seed)

    def per_node(k, n):
        return torch.tensor(0.3 * rng.standard_normal((k, n, n)),
                            dtype=data.dtype, device=data.device)

    return dataclasses.replace(
        data, sqrtQ=per_node(t.n - 1, meta.nx),
        sqrtR=per_node(t.n - 1, meta.nu),
        sqrtQN=per_node(t.n_leaf, meta.nx))


def _parents(tree):
    """The parent of each non-root node, in the non-root order."""
    out = []
    for t in range(1, tree.N):
        m = tree.stage_size(t - 1)
        base = tree.stage_offset(t - 1)
        out += [base + k % m for k in range(tree.d * m)]
    return torch.tensor(out)


def _blocks_from_node_minor(consts, meta, x, u, qx, ru, qNx):
    """The cost blocks of L and L' as the node body computes them, node by
    node from the node-minor copies nQ [nx, nx, n - 1], nR [nu, nu, n - 1]
    and nQN [nx, nx, n_leaf] (entry (r, q) of node j's matrix at [r, q, j]):
    qx_j = sqrtQ_j x_parent, ru_j, qNx_l = sqrtQN_l x_l, and the L' sums
    sum over the children c of sqrtQ_c' qx_c (sqrtR' ru), sqrtQN_l' qNx_l."""
    nQ, nR, nQN = consts[sweep_kernels.N_CONSTS:]
    t = meta.tree
    par = _parents(t)
    n_nl = t.n_nonleaf
    L = (torch.einsum("rqj,bqj->brj", nQ, x[..., par]),
         torch.einsum("rqj,bqj->brj", nR, u[..., par]),
         torch.einsum("rqj,bqj->brj", nQN, x[..., n_nl:]))
    ltq = torch.einsum("rqj,brj->bqj", nQ, qx)
    ltr = torch.einsum("rqj,brj->bqj", nR, ru)
    sum_q = torch.zeros(x.shape[:-1] + (n_nl,), dtype=x.dtype)
    sum_r = torch.zeros(u.shape[:-1] + (n_nl,), dtype=u.dtype)
    sum_q.index_add_(-1, par, ltq)
    sum_r.index_add_(-1, par, ltr)
    LT = (sum_q, sum_r, torch.einsum("rqj,brj->bqj", nQN, qNx))
    return L, LT


@pytest.mark.parametrize("N, d", [(4, 2), (3, 3)])
def test_node_minor_copies_give_linops_cost_blocks(N, d):
    """The node-minor copies of per-node sqrtQ, sqrtR and sqrtQN that
    _consts makes for the node body, read as the body reads them, give the
    cost blocks of linop's L and L' (float64, CPU)."""
    uniform, meta = build(server_heat.make_spec(N=N, nx=4, d=d),
                          dtype=torch.float64, device="cpu")
    # uniform matrices have no copy: the kernel stages them
    assert sweep_kernels._consts(uniform, meta)[sweep_kernels.N_CONSTS:] == [
        None, None, None]
    data = _nonsymmetric_costs(uniform, meta)
    consts = sweep_kernels._consts(data, meta)
    assert len(consts) == sweep_kernels.N_CONSTS + 3
    for a, copy in zip((data.sqrtQ, data.sqrtR, data.sqrtQN),
                       consts[sweep_kernels.N_CONSTS:]):
        assert copy.is_contiguous()
        assert tuple(copy.shape) == tuple(a.shape[1:]) + (a.shape[0],)
    rng = np.random.default_rng(0)
    z, v = sweep_kernels.new_pair(meta, 2, lambda s: torch.tensor(
        rng.standard_normal(s)))
    L, LT = _blocks_from_node_minor(consts, meta, z.x, z.u, v.qx, v.ru,
                                    v.qNx)
    Lz = linop.apply_L(data, meta, z)
    LTv = linop.apply_LT(data, meta, v)
    n_nl = meta.tree.n_nonleaf
    # L' minus its other terms: cx (cxN) and the polytope rows (none here)
    for got, ref in zip(L + LT, (Lz.qx, Lz.ru, Lz.qNx,
                                 LTv.x[..., :n_nl] - v.cx, LTv.u - v.cu,
                                 LTv.x[..., n_nl:] - v.cxN)):
        torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)


# ---- on the card ----

FUSED = {
    "cp_sweep_fused": (
        lambda d, m, z, v, dz, dv, x0, tau: sweep_kernels.cp_sweep_fused(
            d, m, z, v, 0.21, 0.37, x0),
        lambda d, m, z, v, dz, dv, x0, tau: common.cp_sweep_ref(
            d, m, z, v, 0.21, 0.37, x0)),
    "cp_sweep_metric_fused": (
        lambda d, m, z, v, dz, dv, x0, tau: (
            sweep_kernels.cp_sweep_metric_fused(d, m, z, v, 0.21, 0.37, x0)),
        lambda d, m, z, v, dz, dv, x0, tau: common.cp_sweep_metric_ref(
            d, m, z, v, 0.21, 0.37, x0)),
    "candidate_sweep_fused": (
        lambda d, m, z, v, dz, dv, x0, tau: (
            sweep_kernels.candidate_sweep_fused(d, m, z, v, dz, dv, tau, 0.21,
                                                0.37, x0)),
        lambda d, m, z, v, dz, dv, x0, tau: common.candidate_sweep_ref(
            d, m, z, v, dz, dv, tau, 0.21, 0.37, x0)),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _hold_sweep(data, meta, name, dtype, body, B=3):
    """The sweep kernel ``name`` against its plain version on random inputs
    at B lanes, on the body ``body`` (one launch of it, none of the other).
    float64: within 1e-9.  float32: within 1e-5 (1 + max|plain|) per output,
    since the kernel sums the reductions and the matrix rows in another
    order than PyTorch."""
    assert sweep_kernels.sweep_body(meta, data, dtype) == body
    rng = np.random.default_rng(0)

    def pair():
        return sweep_kernels.new_pair(meta, B, lambda s: torch.tensor(
            rng.standard_normal(s), dtype=dtype, device="cuda"))

    (z, v), (dz, dv) = pair(), pair()
    x0 = torch.tensor(rng.standard_normal((B, meta.nx)), dtype=dtype,
                      device="cuda")
    tau = torch.tensor(rng.random(B), dtype=dtype, device="cuda")
    kernel, plain = FUSED[name]
    before = dict(sweep_kernels.LAUNCHES)
    got = leaves(kernel(data, meta, z, v, dz, dv, x0, tau))
    torch.cuda.synchronize()
    after = sweep_kernels.LAUNCHES
    other = "element" if body == "node" else "node"
    assert after[name] == before[name] + 1
    assert after[f"cp_sweep_{body}_body"] == before[f"cp_sweep_{body}_body"] + 1
    assert after[f"cp_sweep_{other}_body"] == before[f"cp_sweep_{other}_body"]
    ref = leaves(plain(data, meta, z, v, dz, dv, x0, tau))
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        err = float((g - r).abs().max())
        if dtype == torch.float64:
            assert err <= 1e-9, i
        else:
            assert err <= 1e-5 * (1 + float(r.abs().max())), i


def _full_width(dtype, per_node_costs):
    """server_heat N=4 at the headline's width (nx = nu = 20) with
    _navar's per-node AV@R and polytope rows, and with ``per_node_costs``
    per-node, non-symmetric cost square roots."""
    spec = server_heat.make_spec(N=4, nx=20, d=2)
    navar, _ = chip_smoke.wide_specs(spec)
    data, meta = build(navar, dtype=dtype)
    return (_nonsymmetric_costs(data, meta) if per_node_costs else data), meta


@pytest.mark.cuda
@pytest.mark.parametrize("costs", ["uniform", "per_node"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", list(FUSED))
def test_node_body_matches_plain_version_at_full_width(name, dtype, costs):
    _card()
    data, meta = _full_width(dtype, costs == "per_node")
    _hold_sweep(data, meta, name, dtype, "node")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", list(FUSED))
def test_element_body_matches_plain_version_above_32_states(name, dtype):
    """server_heat N=3 nx=nu=33 with per-node costs: the element body."""
    _card()
    data, meta = build(server_heat.make_spec(N=3, nx=33, d=2), dtype=dtype)
    _hold_sweep(_nonsymmetric_costs(data, meta), meta, name, dtype,
                "element")


@pytest.mark.cuda
@pytest.mark.parametrize("costs", ["uniform", "per_node"])
def test_node_body_with_costates_in_device_memory(costs):
    """server_heat N=11 nx=20 in float64: the node body's costates in
    device memory."""
    _card()
    data, meta = build(server_heat.make_spec(N=11, nx=20, d=2),
                       dtype=torch.float64)
    if costs == "per_node":
        data = _nonsymmetric_costs(data, meta)
    assert not sweep_kernels.node_plan(
        meta, data, 8)["costates_in_shared_memory"]
    for name in FUSED:
        _hold_sweep(data, meta, name, torch.float64, "node", B=2)


@pytest.mark.cuda
def test_node_plan_matches_the_kernel_planner_on_the_card():
    """sweep_kernels.node_plan against csrc/cp_sweep.cu's own planner, for
    both value types and every kind of cost."""
    _card()
    fn = _build.library("cp_sweep").cp_sweep_plan
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    cases = [build(server_heat.make_spec(N=N, nx=nx, d=d),
                   dtype=torch.float64, device="cpu")
             for N, nx, d in ((10, 20, 2), (11, 20, 2), (5, 32, 3),
                              (3, 33, 2))]
    cases += [(_nonsymmetric_costs(d_, m_), m_) for d_, m_ in cases[:2]]
    for data, meta in cases:
        dims = sweep_kernels._dims(data, meta, True)
        for itemsize in (4, 8):
            out = (ctypes.c_int * 4)()
            rc = fn(ctypes.addressof(dims), itemsize, ctypes.addressof(out))
            plan = sweep_kernels.node_plan(meta, data, itemsize)
            if plan is None:
                assert rc != 0 and list(out) == [-1] * 4
                continue
            assert rc == 0
            assert list(out) == [plan["bytes"],
                                 int(plan["costates_in_shared_memory"]),
                                 plan["riccati_groups"],
                                 plan["costate_values"]]
    # the step kernels' planner is the same function
    data, meta = cases[0]
    assert spstep.smem_plan(data, meta, torch.float32)["bytes"] == 138672


@pytest.mark.cuda
def test_a_node_body_request_outside_its_class_raises(monkeypatch):
    """The C entry refuses a node-body launch it cannot plan (here nx = 33,
    with the host's plan forced to claim a fit), and the wrapper raises
    without counting a launch: nothing falls back to the other body."""
    _card()
    data, meta = build(server_heat.make_spec(N=3, nx=33, d=2),
                       dtype=torch.float64)
    fake = dict(bytes=0, costates_in_shared_memory=False, riccati_groups=1,
                costate_values=64 * 36)
    monkeypatch.setattr(sweep_kernels, "node_plan", lambda *a: fake)
    assert sweep_kernels.sweep_body(meta, data, torch.float64) == "node"
    z, v = sweep_kernels.new_pair(meta, 2, lambda s: torch.zeros(
        s, dtype=torch.float64, device="cuda"))
    x0 = torch.zeros((2, meta.nx), dtype=torch.float64, device="cuda")
    before = dict(sweep_kernels.LAUNCHES)
    with pytest.raises(RuntimeError, match="launch failed: CUDA error 1"):
        sweep_kernels.cp_sweep_fused(data, meta, z, v, 0.2, 0.3, x0)
    assert sweep_kernels.LAUNCHES == before
