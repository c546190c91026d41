"""The metric kernel's two bodies (csrc/metric_apply.cu, TPU kernel #5):
which problems take the node body (step_body.cuh's metric pass, its lanes
spread over blocks) and which the element body, its shared-memory plan and
launch geometry, and on the card both bodies against linop.metric_apply,
with every output pre-filled with NaN so that an entry no thread writes
shows.

This file imports no JAX, so its card tests also run on a machine without
JAX:  python -m pytest tests/test_torch_metric_node.py -m cuda --noconftest
-o addopts="" -p no:cacheprovider
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from spock_tpu_torch import build
from spock_tpu_torch.models import server_heat
from spock_tpu_torch.ops import _build, linop, sweep_kernels
from spock_tpu_torch.zv import leaves

torch.set_num_threads(1)

NODE, ELEMENT = sweep_kernels.NODE, sweep_kernels.ELEMENT


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
    assert sweep_kernels.metric_body(meta, data, dtype) == NODE


@pytest.mark.parametrize("nx, body", [(32, NODE), (33, ELEMENT)])
def test_wider_problems_take_the_element_body(nx, body):
    """The node body holds a node's columns in registers: nx, nu and the
    polytope rows of a node are at most 32, as for the sweep kernels."""
    data, meta = build(server_heat.make_spec(N=2, nx=nx, d=2),
                       dtype=torch.float64, device="cpu")
    for dtype in (torch.float32, torch.float64):
        assert sweep_kernels.metric_body(meta, data, dtype) == body
        assert sweep_kernels.sweep_body(meta, data, dtype) == body
    small, small_meta = build(server_heat.make_spec(N=2, nx=3, d=2),
                              dtype=torch.float64, device="cpu")
    for rows in ("nc_nl", "nc_lf"):
        wide = dataclasses.replace(small_meta, **{rows: nx})
        assert (sweep_kernels.metric_plan(wide, small, 8) is None) == (
            body == ELEMENT)


def test_body_choice_raises_on_an_unsupported_class():
    data, meta = build(server_heat.make_spec(N=3, nx=3, d=2),
                       dtype=torch.float64, device="cpu")
    meta = dataclasses.replace(meta, cone=(("soc", meta.ny),))
    with pytest.raises(ValueError, match="unsupported problem class"):
        sweep_kernels.metric_body(meta, data, torch.float64)


def test_metric_plan_stages_the_uniform_cost_matrices_alone(headline_specs):
    """sqrtQ, sqrtR, sqrtQN and their transposes, 20 x 20 each at the
    headline: 9,600 bytes a block in float32, 19,200 in float64, against
    the sweep body's 138,672 and 226,144; per-node costs stage nothing."""
    data, meta = headline_specs["headline"]
    for itemsize, nbytes in ((4, 9600), (8, 19200)):
        assert sweep_kernels.metric_plan(meta, data, itemsize) == dict(
            bytes=nbytes)
        assert (8 * nbytes < sweep_kernels.node_plan(
            meta, data, itemsize)["bytes"])
    pdata, pmeta = headline_specs["pncost"]
    assert sweep_kernels.metric_plan(pmeta, pdata, 4) == dict(bytes=0)


@pytest.mark.parametrize("B, groups", [(1, 1), (4, 1), (128, 32),
                                       (130, 33)])
def test_launch_geometry(headline_specs, B, groups):
    """(node tiles x lane groups) blocks of one warp per lane: 32 tiles of
    32 nodes for the headline's 1,023 nodes, 4 lanes a block (the last
    group's surplus warps idle)."""
    _, meta = headline_specs["headline"]
    grid = sweep_kernels.metric_grid(meta, B)
    assert grid == dict(tiles=32, groups=groups, lanes=4, threads=128)


def test_launches_are_counted_by_body():
    assert {"metric_apply_fused", "metric_apply_node_body",
            "metric_apply_element_body"} <= set(sweep_kernels.LAUNCHES)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper is linop.metric_apply, and counts no
    launch."""
    data, meta = build(server_heat.make_spec(N=3, nx=4, d=2),
                       dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(0)
    z, v = sweep_kernels.new_pair(meta, 2, lambda s: torch.tensor(
        rng.standard_normal(s)))
    before = dict(sweep_kernels.LAUNCHES)
    got = sweep_kernels.metric_apply_fused(data, meta, z, v, 0.2, 0.3)
    ref = linop.metric_apply(data, meta, z, v, 0.2, 0.3)
    assert sweep_kernels.LAUNCHES == before
    for g, r in zip(leaves(got), leaves(ref)):
        assert torch.equal(g, r)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


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


def _hold(monkeypatch, data, meta, dtype, body, B):
    """metric_apply_fused against linop.metric_apply on random inputs at B
    lanes, one launch of ``body``, its outputs allocated filled with NaN.
    float64: within 1e-9.  float32: within 1e-5 (1 + max|plain|) per
    block, since the kernel sums the matrix rows in another order."""
    assert sweep_kernels.metric_body(meta, data, dtype) == body
    rng = np.random.default_rng(0)
    z, v = sweep_kernels.new_pair(meta, B, lambda s: torch.tensor(
        rng.standard_normal(s), dtype=dtype, device="cuda"))
    nan_empty = sweep_kernels._empty
    before = dict(sweep_kernels.LAUNCHES)
    with monkeypatch.context() as m:
        m.setattr(sweep_kernels, "_empty", lambda *a: [
            None if t is None else t.fill_(float("nan"))
            for t in nan_empty(*a)])
        got = leaves(sweep_kernels.metric_apply_fused(data, meta, z, v, 0.21,
                                                      0.37))
    torch.cuda.synchronize()
    after = sweep_kernels.LAUNCHES
    other = ELEMENT if body == NODE else NODE
    assert after["metric_apply_fused"] == before["metric_apply_fused"] + 1
    assert (after[f"metric_apply_{body}_body"]
            == before[f"metric_apply_{body}_body"] + 1)
    assert (after[f"metric_apply_{other}_body"]
            == before[f"metric_apply_{other}_body"])
    ref = leaves(linop.metric_apply(data, meta, z, v, 0.21, 0.37))
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert bool(torch.isfinite(g).all()), i
        err = float((g - r).abs().max())
        if dtype == torch.float64:
            assert err <= 1e-9, i
        else:
            assert err <= 1e-5 * (1 + float(r.abs().max())), i
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4, 128])
@pytest.mark.parametrize("costs", ["uniform", "per_node"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_node_body_matches_plain_version_at_full_width(monkeypatch, dtype,
                                                       costs, B):
    """The headline's width and depth (server_heat N=10 nx=nu=20) with
    _navar's per-node AV@R and polytope rows, and with per-node,
    non-symmetric cost square roots."""
    _card()
    navar, _ = chip_smoke.wide_specs(server_heat.make_spec(N=10, nx=20,
                                                           d=2))
    data, meta = build(navar, dtype=dtype)
    if costs == "per_node":
        data = _nonsymmetric_costs(data, meta)
    _hold(monkeypatch, data, meta, dtype, NODE, B)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_node_body_values_do_not_depend_on_the_lane_group(dtype):
    """17 lanes (a last group of one lane) give each lane's values bit for
    bit as that lane launched alone: a thread's arithmetic is its node's
    alone, whatever the block's other warps."""
    _card()
    data, meta = build(server_heat.make_spec(N=5, nx=20, d=2), dtype=dtype)
    rng = np.random.default_rng(4)
    z, v = sweep_kernels.new_pair(meta, 17, lambda s: torch.tensor(
        rng.standard_normal(s), dtype=dtype, device="cuda"))
    whole = leaves(sweep_kernels.metric_apply_fused(data, meta, z, v, 0.21,
                                                    0.37))
    for lane in (0, 5, 16):
        zl, vl = (type(x)(**{
            k: None if a is None else a[lane:lane + 1].clone()
            for k, a in vars(x).items()}) for x in (z, v))
        alone = leaves(sweep_kernels.metric_apply_fused(data, meta, zl, vl,
                                                        0.21, 0.37))
        for a, b in zip(whole, alone):
            assert torch.equal(a[lane:lane + 1], b), lane


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_element_body_matches_plain_version_above_32_states(monkeypatch,
                                                            dtype):
    """server_heat N=3 nx=nu=33 with per-node costs: the element body."""
    _card()
    data, meta = build(server_heat.make_spec(N=3, nx=33, d=2), dtype=dtype)
    _hold(monkeypatch, _nonsymmetric_costs(data, meta), meta, dtype, ELEMENT,
          3)


@pytest.mark.cuda
def test_metric_plan_matches_the_kernel_planner_on_the_card():
    """sweep_kernels.metric_plan against csrc/metric_apply.cu's own planner,
    for both value types and every kind of cost."""
    _card()
    fn = _build.library("metric_apply").metric_apply_plan
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    cases = [build(server_heat.make_spec(N=N, nx=nx, d=d),
                   dtype=torch.float64, device="cpu")
             for N, nx, d in ((10, 20, 2), (5, 32, 3), (3, 33, 2))]
    cases += [(_nonsymmetric_costs(d_, m_), m_) for d_, m_ in cases[:2]]
    for data, meta in cases:
        dims = sweep_kernels._dims(data, meta, False)
        for itemsize in (4, 8):
            out = ctypes.c_int()
            rc = fn(ctypes.addressof(dims), itemsize, ctypes.addressof(out))
            plan = sweep_kernels.metric_plan(meta, data, itemsize)
            if plan is None:
                assert rc != 0 and out.value == -1
            else:
                assert rc == 0 and out.value == plan["bytes"]


@pytest.mark.cuda
def test_a_node_body_request_outside_its_class_raises(monkeypatch):
    """The C entry refuses a node-body launch it cannot plan (here nx = 33,
    with the host's plan forced to claim a fit), and the wrapper raises
    without counting a launch: nothing falls back to the other body."""
    _card()
    data, meta = build(server_heat.make_spec(N=3, nx=33, d=2),
                       dtype=torch.float64)
    monkeypatch.setattr(sweep_kernels, "metric_plan",
                        lambda *a: dict(bytes=0))
    assert sweep_kernels.metric_body(meta, data, torch.float64) == NODE
    z, v = sweep_kernels.new_pair(meta, 2, lambda s: torch.zeros(
        s, dtype=torch.float64, device="cuda"))
    before = dict(sweep_kernels.LAUNCHES)
    with pytest.raises(RuntimeError, match="launch failed: CUDA error 1"):
        sweep_kernels.metric_apply_fused(data, meta, z, v, 0.2, 0.3)
    assert sweep_kernels.LAUNCHES == before
