"""The port's examples that scale (``examples/torch_pod_scale.py``,
``torch_bigtree_scaling.py``, ``torch_multihost_eff.py``), each run in a
subprocess on the CPU at its small size with ``--cpu --out-dir tmp``: they
write their rows, and nothing under ``examples/output/`` changes.  Also the
property the pod-scale leg rests on: a farm lane does not depend on the
number of lanes beside it (held bitwise on the card by chip_smoke.py phase
10 and tests/test_torch_farm_graph.py)."""

import numpy as np
import torch

from spock_tpu_torch import build, mpc
from spock_tpu_torch.models import server_heat
from spock_tpu_torch.solver import zero_dual, zero_primal
from spock_tpu_torch.zv import leaves
from tests.test_torch_examples_solve import load, run_example

torch.set_num_threads(1)


def test_pod_scale_chip_leg(tmp_path):
    """The lane-scaling leg at B = 4, 8 (N=3 nx=3): a row per B with
    solves/s and the carry's bytes a lane (ten (z, v) pairs and the
    scalars), and ``reduced`` naming the cut."""
    run_example("pod_scale", tmp_path, "--horizon", 3, "--nx", 3, "--bs",
                "4,8", "--steps", 2, "--warm-steps", 1)
    out = load(tmp_path, "torch_pod_scale.json")
    assert out["card"] == "cpu" and out["paths"]["use_fused_step"]
    assert [r["B"] for r in out["rows"]] == [4, 8]
    data, meta = build(server_heat.make_spec(N=3, nx=3, d=2),
                       dtype=torch.float32, device="cpu")
    pair = sum(a.numel() * 4 for a in leaves(
        (zero_primal(meta, (1,), torch.float32, "cpu"),
         zero_dual(meta, (1,), torch.float32, "cpu"))))
    for row in out["rows"]:
        assert row["solves"] == 2 * row["B"] and row["solves_per_s"] > 0
        assert 10 * pair < row["carry_bytes_per_lane"] < 10 * pair + 200
    assert out["reduced"]["bs"] == "4,8"


def test_pod_scale_mesh_leg(tmp_path):
    """The lane-sharding leg over 1 and 2 gloo processes at 8 lanes: a row
    per rank count, every lane's steps done."""
    run_example("pod_scale", tmp_path, "--leg", "mesh", "--horizon", 3,
                "--nx", 3, "--lanes", 8, "--steps", 2, "--warm-steps", 1,
                "--ranks", "1,2")
    out = load(tmp_path, "torch_pod_scale_mesh.json")
    assert out["backend"] == "gloo"
    assert [r["ranks"] for r in out["rows"]] == [1, 2]
    for row in out["rows"]:
        assert row["solves"] == 2 * 8 and row["solves_per_s"] > 0
    assert out["rows"][0]["rate_vs_1rank"] == 1.0


def test_bigtree_scaling(tmp_path):
    """The node-sharded solves at N=5 over 1 and 2 gloo processes: a row
    per (ranks, algorithm); CP runs the same iterations on both and ends at
    the same residuals (float32 reductions in another order: 1e-5
    relative); one rank runs no boundary exchange, two do."""
    run_example("bigtree_scaling", tmp_path, "--horizon", 5, "--iters", 10,
                "--ranks", "1,2")
    out = load(tmp_path, "torch_bigtree_scaling_gloo.json")
    rows = {(r["ranks"], r["algo"]): r for r in out["rows"]}
    assert set(rows) == {(p, a) for p in (1, 2) for a in ("cp", "spock")}
    one, two = rows[1, "cp"], rows[2, "cp"]
    assert one["iters"] == two["iters"] == 10
    np.testing.assert_allclose([two["xi1"], two["xi2"]],
                               [one["xi1"], one["xi2"]], rtol=1e-5)
    assert "all_gather" not in one["collectives_by_kind"]
    assert two["collectives_by_kind"]["all_gather"]["count"] > 0


def test_multihost_eff(tmp_path):
    """The weak-scaling efficiency over 1 and 2 gloo processes at 2 lanes a
    process: both runs converge, and the efficiency is their rates'
    ratio."""
    run_example("multihost_eff", tmp_path, "--b-local", 2, "--solves", 1,
                "--horizon", 3, "--nx", 3)
    out = load(tmp_path, "torch_multihost_eff.json")
    one, two = out["one_process"], out["two_process"]
    assert one["converged"] and two["converged"]
    assert (one["B_global"], two["B_global"]) == (2, 4)
    assert out["weak_scaling_efficiency"] == (
        two["rate_solves_per_s"] / (2 * one["rate_solves_per_s"]))
    assert out["reduced"]["jax_script"]["b_local"] == 32


def test_farm_lanes_do_not_depend_on_the_batch():
    """server_heat N=3 nx=4 on the CPU: the cold window (2 steps) of a
    16-lane farm in chunks of 6, its first 4 lanes those of a 4-lane farm
    and the others drawn from another seed; those lanes equal the 4-lane
    farm's bitwise (a lane's solves read no other lane, and a done lane
    is frozen)."""
    data, meta = build(server_heat.make_spec(N=3, nx=4, d=2),
                       dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    x0, ws = rng.uniform(-0.6, 0.6, (4, meta.nx)), rng.integers(0, 2, (3, 4))
    rng = np.random.default_rng(11)
    xb = np.concatenate([x0, rng.uniform(-0.6, 0.6, (12, meta.nx))])
    wb = np.concatenate([ws, rng.integers(0, 2, (3, 12))], axis=1)
    ref = mpc.simulate_async(data, meta, x0, ws, 1e-3, n_steps=2,
                             device="cpu", iters_per_launch=6)
    got = mpc.simulate_async(data, meta, xb, wb, 1e-3, n_steps=2,
                             device="cpu", iters_per_launch=6)
    assert bool((got.steps_done == 2).all())
    assert torch.equal(got.steps_done[:4], ref.steps_done)
    assert torch.equal(got.iters_per_step[:, :4], ref.iters_per_step)
    assert torch.equal(got.us[:, :4], ref.us)
    assert torch.equal(got.xs[:4], ref.xs)
    for a, b in zip(leaves((got.z, got.v)), leaves((ref.z, ref.v))):
        assert torch.equal(a[:4], b)
