"""The subtree partition of ``spock_tpu_torch.parallel.bigtree`` and the
operators of a rank's share, in the test process (no JAX, no worker
processes).

The partition splits stage k's columns over the ranks; below it each rank
holds its columns' descendants in the sibling-major layout, above it the
replicated top.  ``bigtree.Part`` is that layout, which the unsharded
operators read as ``meta.tree``.  On one process the share's operators run
with the stage forced (a one-rank gloo mesh, every boundary exchange
included).  The node-sharded solves across processes are in
``tests/test_torch_bigtree.py`` and ``tests/test_torch_bigtree_sp.py``.
"""

import numpy as np
import pytest
import torch

from spock_tpu_torch import build
from spock_tpu_torch.algorithms import cp as cp_alg
from spock_tpu_torch.models import server_heat
from spock_tpu_torch.ops import linop, prox
from spock_tpu_torch.parallel import bigtree, mesh as pmesh
from spock_tpu_torch.solver import zero_dual, zero_primal
from spock_tpu_torch.tree import UniformTree
from spock_tpu_torch.zv import leaves, tmap, vdot

torch.set_num_threads(1)


def _local_parents(p):
    """Local index of each non-root local node's parent as the share's
    operators find it: the forest's sibling-major parent below stage k, the
    top's column c % d^(k-1) for stage k's column c; and its realization
    index."""
    d, k = p.tree.d, p.k
    par, w = [], []
    for s in range(1, p.tree.N):
        loc = np.arange(p.stage_size(s))
        if s == k:
            par.append(p.stage_offset(s - 1) + (p.a + loc) % d ** (k - 1))
            w.append((p.a + loc) // d ** (k - 1))
        else:
            par.append(p.stage_offset(s - 1) + loc % p.stage_size(s - 1))
            w.append(loc // p.stage_size(s - 1))
    return np.concatenate(par), np.concatenate(w)


def _local_children(p, g):
    """The whole tree's index of each local non-leaf node's d children as
    the share's operators find them: the block ``j * size(s) + loc`` of
    the next stage, which at stage k - 1 is the stage gathered whole."""
    d, k, t = p.tree.d, p.k, p.tree
    out = []
    for s in range(t.N - 1):
        loc = np.arange(p.stage_size(s))
        kids = np.arange(d)[None, :] * p.stage_size(s) + loc[:, None]
        if s + 1 == k:  # gathered: stage k's global columns
            out.append(t.stage_offset(k) + kids)
        else:
            out.append(g[p.stage_offset(s + 1) + kids])
    return np.concatenate(out)


@pytest.mark.parametrize("N,d", [(5, 2), (6, 2), (5, 3), (6, 3)])
def test_partition_owns_every_node_once_with_the_trees_maps(N, d):
    """For 1-4 ranks (uneven blocks included): each node is owned by one
    rank's forest or lies in the replicated top, and a rank's local
    parents, realization indices and children are the whole tree's."""
    tree = UniformTree(N, d)
    parent = np.array([-1] + [tree.parent(j) for j in range(1, tree.n)])
    w = np.array([-1] + [tree.w(j) for j in range(1, tree.n)])
    for ranks in (1, 2, 3, 4):
        parts = [bigtree.Part.make(tree, ranks, r) for r in range(ranks)]
        k = parts[0].k
        assert k == (0 if ranks == 1 else min(
            next(s for s in range(1, N) if d ** s >= 8 * ranks
                 or s == N - 1), N - 1))
        sizes = [p.b - p.a for p in parts]
        assert max(sizes) - min(sizes) <= 1 and sum(sizes) == d ** k
        owned = np.concatenate([p.global_nodes()[p.n_top:] for p in parts])
        top = parts[0].global_nodes()[:parts[0].n_top]
        np.testing.assert_array_equal(np.sort(np.concatenate([top, owned])),
                                      np.arange(tree.n))
        for p in parts:
            g = p.global_nodes()
            np.testing.assert_array_equal(g[:p.n_top], top)
            local_parent, local_w = _local_parents(p)
            np.testing.assert_array_equal(g[local_parent], parent[g[1:]])
            np.testing.assert_array_equal(local_w, w[g[1:]])
            assert (p.n, p.n_leaf) == (len(g), len(g) - p.n_nonleaf)
            kids = _local_children(p, g)
            for i in range(p.n_nonleaf):
                assert tuple(kids[i]) == tree.children(g[i])


def test_rank_holds_its_share_of_the_bytes():
    """Per-rank bytes of a (z, v) pair: at most the whole over P, rounded up
    to whole stage-k blocks, plus the replicated top (server_heat N=7 nx=4
    d=3, 1,093 nodes, as test_node_sharding's memory test); equal to the
    whole over P plus the top where P divides d^k."""
    data, meta = build(server_heat.make_spec(N=7, nx=4, d=3),
                       dtype=torch.float64, device="cpu")
    whole = bigtree.pair_bytes(meta, dict(
        all=meta.tree.n, nl=meta.tree.n_nonleaf, nr=meta.tree.n - 1,
        lf=meta.tree.n_leaf), 1, 8)
    assert whole == 8 * (meta.nz + meta.nv)
    for ranks in (2, 3, 4):
        parts = [bigtree.Part.make(meta.tree, ranks, r)
                 for r in range(ranks)]
        cols = meta.tree.d ** parts[0].k
        top = bigtree.pair_bytes(meta, parts[0].top_counts(), 1, 8)
        for p in parts:
            got = bigtree.pair_bytes(meta, p.counts(), 1, 8)
            widest = -(-cols // ranks) / cols
            assert got <= widest * (whole - top) + top + 1e-9
            if cols % ranks == 0:
                assert got == pytest.approx((whole - top) / ranks + top)
        assert top < whole / 20


def test_sharded_operators_on_one_rank_at_every_stage():
    """On a one-rank gloo mesh with the stage forced to each of 0..N-1 (a
    polytope problem: every block of L): L, L', prox_f and the reductions
    of the share equal the unsharded operators exactly, and a CP solve
    equals the unsharded one bitwise."""
    import dataclasses

    from spock_tpu_torch import problem

    spec = server_heat.make_spec(N=5, nx=3, d=3)
    Gx = np.ones((1, 3))
    spec = dataclasses.replace(spec, polytope=problem.Polytope(
        Gx=Gx, Gu=np.zeros((1, 3)), lo=np.array([-2.0]), hi=np.array([2.0]),
        GxN=Gx, loN=np.array([-2.0]), hiN=np.array([2.0])))
    data, meta = build(spec, dtype=torch.float64, device="cpu")
    mesh = pmesh.make_mesh(device="cpu")
    rng = np.random.default_rng(0)

    def rnd(tree):
        return tmap(lambda a: torch.tensor(rng.standard_normal(a.shape)),
                    tree)

    z = rnd(zero_primal(meta, (2,), torch.float64, "cpu"))
    v = rnd(zero_dual(meta, (2,), torch.float64, "cpu"))
    x0 = torch.tensor(rng.uniform(-0.5, 0.5, (2, 3)))
    ref = cp_alg.run_cp(data, meta, x0, zero_primal(meta, (2,),
                                                    torch.float64, "cpu"),
                        zero_dual(meta, (2,), torch.float64, "cpu"), 1e-6,
                        60, fused_sweep=False)

    def same(a, b):
        for x, y in zip(leaves(a), leaves(b)):
            assert torch.equal(x, y)

    for stage in range(meta.tree.N):
        sh = bigtree.Sharded(data, meta, mesh, stage)
        zl, vl = sh.share(z), sh.share(v)
        same(sh.whole(linop.apply_L(sh.data, sh.meta, zl)),
             linop.apply_L(data, meta, z))
        same(sh.whole(linop.apply_LT(sh.data, sh.meta, vl)),
             linop.apply_LT(data, meta, v))
        same(sh.whole(prox.prox_f(sh.data, sh.meta, zl, 0.3, x0)),
             prox.prox_f(data, meta, z, 0.3, x0))
        torch.testing.assert_close(sh.ops.vdot((zl, vl), (zl, vl), 1),
                                   vdot((z, v), (z, v), 1), rtol=1e-14,
                                   atol=0)
        res, _ = bigtree.run_cp_sharded(data, meta, x0, 1e-6, 60, mesh,
                                        stage=stage)
        torch.testing.assert_close(res.iterations, ref.iterations)
        same((res.z, res.v), (ref.z, ref.v))
