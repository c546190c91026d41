"""Node-sharded solves of one large tree over the ranks of a mesh.

The JAX package (``spock_tpu/parallel/bigtree.py``) pads the flat node axis
to a multiple of the mesh, splits it evenly and lets GSPMD insert whatever
collectives the sibling-major regrouping needs.  Here the partition follows
the tree, and the communication is what the tree needs:

* **The partition.**  Stage ``k`` is the smallest with ``d**k >= 8 P``
  (at most ``N - 1``; ``k = 0`` on one rank).  Its ``d**k`` nodes split
  into P contiguous column blocks whose sizes differ by at most one, and
  rank r owns the descendants of its block ``[a, b)``.  Viewed as a
  ``[d**(t-k), d**k]`` array, stage t >= k holds those descendants in the
  same columns ``[a, b)``; taken row-major they keep the sibling-major
  layout (the parent of stage-local ``loc`` is ``loc % size(t-1)``, its
  realization index ``loc // size(t-1)``) and so every per-stage operation
  runs on them unchanged.  Stages ``0..k-1`` (the *top*,
  ``(d**k - 1)/(d - 1)`` nodes) are replicated on every rank.
* **The layout.**  A rank's iterates are a ``Primal`` and a ``Dual`` whose
  node axes hold its nodes stage-major as the whole tree's do: the top,
  then its columns stage by stage.  Nothing is padded.  :class:`Part` is
  that layout: it has the stage sizes and offsets of
  :class:`~spock_tpu_torch.tree.UniformTree`, and the rank's problem
  carries it as ``meta.tree``, so that the operators of ``ops/linop.py``,
  ``ops/riccati.py`` and ``ops/prox.py`` run on the share as they are.
* **The communication.**  Only the boundary between stages ``k - 1`` and
  ``k`` couples ranks, through the layout's two hooks.  Upward passes (the
  Riccati costates, the child sums of L', the S2 projection of stage
  ``k - 1``) ``gather`` stage k (one ``all_gather`` of ``d**k`` columns a
  field) and finish on the top; downward passes (the Riccati rollout, the
  parent copies of L) run on the top, then ``scatter`` keeps the rank's
  columns of stage k.  Per-node work (prox_h*) is local.  Inner products,
  norms and the Anderson Gram add the ranks' parts (or take their maximum)
  in one ``all_reduce`` per lane vector, each top node counted once (on
  rank 0), so every rank sees the whole tree's residuals and stops with
  the others.
* **The path.**  The composed iteration (PyTorch operators, the plain
  prox_h*) on each rank's share: the exchange sits in the middle of every
  sweep, where no kernel of the port stops.

The JAX package's ``pad_nodes`` and ``unpad_nodes`` have no counterpart
(nothing is padded), nor has ``_comm_stats``'s source, XLA's compiled
program: ``stats=`` counts this module's own collectives.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..algorithms import common
from ..algorithms import supermann as sp_alg
from ..algorithms.anderson import gram
from ..algorithms.common import SolveResult
from ..problem import ProblemData, ProblemMeta
from ..tree import UniformTree
from ..zv import Dual, Primal, inf_norm, leaves, tmap, vdot
from .mesh import Mesh

# the node axis each field's last dim runs over: every node, the non-leaf
# nodes, the non-root nodes, the leaves
_KIND = dict(x="all", s="all", u="nl", y="nl", sby="nl", cx="nl", cu="nl",
             pnl="nl", tau="nr", qx="nr", ru="nr", t5="nr", t6="nr",
             qNx="lf", s12="lf", s13="lf", cxN="lf", plf="lf")
# stage k holds at least this many columns per rank where the tree allows
COLUMNS_PER_RANK = 8


def _widths(meta: ProblemMeta):
    """Each field's feature width (0: one value per node, no feature dim),
    of the Primal and of the Dual; None for an absent polytope block."""
    nx, nu, ny = meta.nx, meta.nu, meta.ny
    return (dict(x=nx, u=nu, s=0, tau=0, y=ny),
            dict(y=ny, sby=0, qx=nx, ru=nu, t5=0, t6=0, cx=nx, cu=nu,
                 qNx=nx, s12=0, s13=0, cxN=nx, pnl=meta.nc_nl or None,
                 plf=meta.nc_lf or None))


def pair_bytes(meta: ProblemMeta, counts: dict, batch: int,
               itemsize: int) -> int:
    """Bytes of a (z, v) pair whose node axes hold ``counts[kind]`` nodes
    (``Part.counts``, or the top's ``Part.top_counts``)."""
    return batch * itemsize * sum(
        max(w, 1) * counts[_KIND[f]] for widths in _widths(meta)
        for f, w in widths.items() if w is not None)


def node_counts(tree) -> dict:
    """Node count of each kind of node axis of a layout (a tree, or a
    :class:`Part`)."""
    return dict(all=tree.n, nl=tree.n_nonleaf, nr=tree.n - 1,
                lf=tree.n_leaf)


def partition_stage(tree: UniformTree, ranks: int) -> int:
    """The stage whose columns are split: the smallest k with
    d^k >= COLUMNS_PER_RANK * ranks, at most N - 1; 0 on one rank."""
    if ranks == 1:
        return 0
    if tree.d ** (tree.N - 1) < ranks:
        raise ValueError(f"{ranks} ranks for {tree.d ** (tree.N - 1)} "
                         "leaves: a rank would own no node")
    k = 1
    while k < tree.N - 1 and tree.d ** k < COLUMNS_PER_RANK * ranks:
        k += 1
    return k


@dataclasses.dataclass(frozen=True)
class Part:
    """One rank's share of a tree split at stage ``k``, as a layout: the
    stage sizes and offsets of :class:`~spock_tpu_torch.tree.UniformTree`
    and its two exchange hooks.

    ``blocks[r] = (a, b)``: rank r's columns of stage k.  Local stage t holds
    ``d**t`` nodes (the top, t < k) or ``(b - a) d**(t-k)``.  ``comm``: the
    collectives of the rank's mesh (:class:`_Comm`), which ``gather``
    needs."""

    tree: UniformTree
    k: int
    blocks: tuple
    rank: int
    comm: Optional["_Comm"] = dataclasses.field(default=None, compare=False,
                                                repr=False)

    @classmethod
    def make(cls, tree: UniformTree, ranks: int, rank: int,
             stage: Optional[int] = None, comm=None) -> "Part":
        k = partition_stage(tree, ranks) if stage is None else int(stage)
        if not 0 <= k <= tree.N - 1 or (k == 0 and ranks > 1):
            raise ValueError(f"cannot split stage {k} of N={tree.N} over "
                             f"{ranks} ranks")
        cols = tree.d ** k
        if cols < ranks:
            raise ValueError(f"stage {k} has {cols} columns for {ranks} "
                             "ranks")
        edges = [r * cols // ranks for r in range(ranks + 1)]
        return cls(tree, k, tuple(zip(edges[:-1], edges[1:])), rank, comm)

    @property
    def a(self) -> int:
        return self.blocks[self.rank][0]

    @property
    def b(self) -> int:
        return self.blocks[self.rank][1]

    @property
    def N(self) -> int:
        return self.tree.N

    @property
    def d(self) -> int:
        return self.tree.d

    def stage_size(self, t: int) -> int:
        d = self.tree.d
        return d ** t if t < self.k else (self.b - self.a) * d ** (t - self.k)

    def stage_offset(self, t: int) -> int:
        return sum(self.stage_size(s) for s in range(t))

    def stage_slice(self, t: int) -> slice:
        return slice(self.stage_offset(t), self.stage_offset(t + 1))

    @property
    def n(self) -> int:
        return self.stage_offset(self.tree.N)

    @property
    def n_nonleaf(self) -> int:
        return self.stage_offset(self.tree.N - 1)

    @property
    def n_leaf(self) -> int:
        return self.n - self.n_nonleaf

    @property
    def leaf_start(self) -> int:
        return self.n_nonleaf

    @property
    def n_top(self) -> int:
        return self.stage_offset(self.k)

    def gather(self, t: int, arrs):
        """Stage t's local blocks [..., F_i, size(t)] of several arrays ->
        the whole stage [..., F_i, d**t] of each: at the split stage, every
        rank's columns in one all_gather; elsewhere the local block is the
        whole stage (the top) or the pass stays local (the forest)."""
        if t != self.k or self.k == 0:
            return arrs
        sizes = [a.shape[-2] for a in arrs]
        full = self.comm.gather_columns(torch.cat(arrs, dim=-2), self.blocks)
        return list(torch.split(full, sizes, dim=-2))

    def scatter(self, t: int, blocks):
        """Blocks that make up the whole stage t -> this rank's columns of
        it at the split stage; elsewhere the blocks as given."""
        if t != self.k or self.k == 0:
            return blocks
        return [torch.cat(blocks, dim=-1)[..., self.a:self.b]]

    def counts(self) -> dict:
        """Local node count of each kind of node axis."""
        return node_counts(self)

    def top_counts(self) -> dict:
        """Node count of each kind of node axis in the replicated top."""
        top = self.n_top
        return dict(all=top, nl=top, nr=max(top - 1, 0), lf=0)

    def owned_from(self) -> dict:
        """Where this rank's own columns start on each kind of node axis:
        rank 0 counts the replicated top, the others skip it."""
        return self.top_counts() if self.rank else dict.fromkeys(
            ("all", "nl", "nr", "lf"), 0)

    def global_nodes(self) -> np.ndarray:
        """The whole tree's index of each local node, in local order."""
        t, d, k = self.tree, self.tree.d, self.k
        out = [np.arange(t.stage_offset(s), t.stage_offset(s + 1))
               for s in range(k)]
        cols = np.arange(self.a, self.b)
        for s in range(k, t.N):
            rows = np.arange(d ** (s - k))[:, None] * d ** k
            out.append(t.stage_offset(s) + (rows + cols[None, :]).ravel())
        return np.concatenate(out)

    def indices(self) -> dict:
        """The whole tree's index on each kind of node axis, per kind."""
        g = self.global_nodes()
        t = self.tree
        return dict(all=g, nl=g[:self.n_nonleaf], nr=g[1:] - 1,
                    lf=g[self.n_nonleaf:] - t.leaf_start)


def _kind_map(f, *trees):
    """tmap that passes each leaf's node-axis kind: f(kind, *leaves)."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, tuple):
        return tuple(_kind_map(f, *parts) for parts in zip(*trees))
    return type(t0)(**{
        fl.name: (None if getattr(t0, fl.name) is None else
                  f(_KIND[fl.name], *(getattr(t, fl.name) for t in trees)))
        for fl in dataclasses.fields(t0)})


class _Comm:
    """The mesh's collectives, counted by kind (calls and bytes out)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.reset()

    def reset(self):
        self.counts = {}

    def _count(self, kind, nbytes):
        c = self.counts.setdefault(kind, [0, 0])
        c[0] += 1
        c[1] += nbytes

    def all_reduce(self, a, op):
        a = a.contiguous()
        dist.all_reduce(a, op=op, group=self.mesh.group)
        self._count("all_reduce", a.numel() * a.element_size())
        return a

    def gather_columns(self, a, blocks):
        """[..., b - a] -> [..., d**k]: every rank's block of stage-k
        columns, in column order (padded to the widest block to send)."""
        width = max(b - a for a, b in blocks)
        send = torch.nn.functional.pad(a, (0, width - a.shape[-1]))
        parts = [torch.empty_like(send) for _ in blocks]
        dist.all_gather(parts, send.contiguous(), group=self.mesh.group)
        self._count("all_gather",
                    len(blocks) * send.numel() * send.element_size())
        return torch.cat([p[..., :b - a] for p, (a, b) in zip(parts, blocks)],
                         dim=-1)


class Sharded:
    """A problem split over a mesh: this rank's ``part``, its ``meta`` (the
    whole problem's, with the part as its tree), its local ``data``
    (per-node arrays cut to its nodes), and the ``ops`` (``common.Ops``:
    the reductions over the mesh, no kernels).  ``share`` and ``whole``
    move iterates between the whole tree's layout and the rank's."""

    def __init__(self, data: ProblemData, meta: ProblemMeta, mesh: Mesh,
                 stage: Optional[int] = None):
        self.mesh = mesh
        self.comm = _Comm(mesh)
        self.part = Part.make(meta.tree, mesh.size, mesh.rank, stage,
                              self.comm)
        self.meta = dataclasses.replace(meta, tree=self.part)
        dev, p = mesh.device, self.part
        if p.k > 0:  # (k = 0: the share is the whole tree)
            self._idx = {kind: torch.as_tensor(ix, device=dev)
                         for kind, ix in p.indices().items()}
        self.data = self._local_data(data)
        self.ops = common.Ops(vdot=self._vdot, inf_norm=self._inf_norm,
                              gram=self._gram, kernels=False)

    # ---- data and iterates between layouts ----

    def _local_data(self, data):
        """The data on the rank's device, per-node arrays (node dim > 1)
        cut to its nodes."""
        data = tmap(lambda a: a.to(self.mesh.device), data)

        def cut(a, kind):
            if a.shape[0] == 1 or self.part.k == 0:
                return a
            return a.index_select(0, self._idx[kind])

        return dataclasses.replace(data, **{
            f: cut(getattr(data, f), kind) for f, kind in (
                ("sqrtQ", "nr"), ("sqrtR", "nr"), ("sqrtQN", "lf"),
                ("E", "nl"), ("F", "nl"), ("b", "nl"), ("ker_proj", "nl"))})

    def share(self, tree):
        """The rank's share of a whole-tree (Primal, Dual, or tuples of
        them) iterate, on its device."""
        if self.part.k == 0:
            return _kind_map(lambda kind, a: a.to(self.mesh.device), tree)
        return _kind_map(lambda kind, a: a.to(self.mesh.device).index_select(
            -1, self._idx[kind]), tree)

    def whole(self, tree):
        """The whole tree's iterate from every rank's share, on every rank
        (the shares' forests all-gathered, the top from this rank)."""
        if self.part.k == 0:
            return tree
        t, mesh = self.part.tree, self.mesh
        parts = [Part(t, self.part.k, self.part.blocks, r)
                 for r in range(mesh.size)]
        idx = [{kind: torch.as_tensor(ix, device=mesh.device)
                for kind, ix in p.indices().items()} for p in parts]
        totals = node_counts(t)

        def put(kind, a):
            a = a.contiguous()
            width = max(p.counts()[kind] for p in parts)
            send = torch.nn.functional.pad(a, (0, width - a.shape[-1]))
            got = [torch.empty_like(send) for _ in parts]
            dist.all_gather(got, send.contiguous(), group=mesh.group)
            out = a.new_empty(a.shape[:-1] + (totals[kind],))
            for g, p, ix in zip(got, parts, idx):
                out.index_copy_(-1, ix[kind], g[..., :p.counts()[kind]])
            return out

        return _kind_map(put, tree)

    def zeros(self, batch: int, dtype) -> tuple:
        """A zero (Primal, Dual) pair on the rank's share, [batch, ...]."""
        c = self.part.counts()

        def make(cls, widths):
            return cls(**{f: None if w is None else torch.zeros(
                (batch,) + ((w,) if w else ()) + (c[_KIND[f]],),
                dtype=dtype, device=self.mesh.device)
                for f, w in widths.items()})

        wp, wd = _widths(self.meta)
        return make(Primal, wp), make(Dual, wd)

    # ---- reductions: every top node counted once ----

    def _owned(self, tree):
        if self.part.rank == 0:
            return tree
        start = self.part.owned_from()
        return _kind_map(lambda kind, a: a[..., start[kind]:], tree)

    def _vdot(self, x, y, batch_ndim: int = 0):
        return self.comm.all_reduce(
            vdot(self._owned(x), self._owned(y), batch_ndim),
            dist.ReduceOp.SUM)

    def _inf_norm(self, x, batch_ndim: int = 0):
        return self.comm.all_reduce(inf_norm(x, batch_ndim),
                                    dist.ReduceOp.MAX)

    def _gram(self, MR, r):
        Gm, cm = gram(self._owned(MR), self._owned(r))
        B, m = cm.shape
        both = self.comm.all_reduce(
            torch.cat([Gm.reshape(B, m * m), cm], dim=1), dist.ReduceOp.SUM)
        return both[:, :m * m].reshape(B, m, m), both[:, m * m:]


def _start(sh: Sharded, x0, z0, v0, data):
    x0 = torch.as_tensor(x0, dtype=data.dtype, device=sh.mesh.device)
    B = x0.shape[0]
    zl, vl = sh.zeros(B, data.dtype)
    if z0 is not None:
        zl = sh.share(z0)
    if v0 is not None:
        vl = sh.share(v0)
    return x0, zl, vl


def _fill_stats(stats, sh: Sharded, iters: int, z, v, B: int, itemsize: int):
    """The collectives per iteration by kind and their bytes, and the
    bytes of this rank's iterates against the whole tree's."""
    by_kind = {kind: dict(count=c / max(iters, 1), bytes=nb / max(iters, 1))
               for kind, (c, nb) in sh.comm.counts.items()}
    meta = sh.meta
    whole = pair_bytes(meta, node_counts(sh.part.tree), B, itemsize)
    local = sum(a.numel() * a.element_size() for a in leaves((z, v)))
    per_iter = sum(k["bytes"] for k in by_kind.values())
    stats.update(
        count=sum(k["count"] for k in by_kind.values()), bytes=per_iter,
        by_kind=by_kind, iterations=iters, stage=sh.part.k,
        ranks=sh.mesh.size, blocks=list(sh.part.blocks),
        iterate_bytes=whole, rank_iterate_bytes=local,
        top_bytes=pair_bytes(meta, sh.part.top_counts(), B, itemsize),
        collective_frac_of_iterate=per_iter / whole)


def run_cp_sharded(data: ProblemData, meta: ProblemMeta, x0, tol,
                   max_iter: int, mesh: Mesh, z0=None, v0=None, gamma=None,
                   sigma=None, stats=None, stage: Optional[int] = None):
    """Chambolle-Pock with node-sharded iterates.  x0: [B, nx], replicated;
    z0/v0: whole-tree warm starts (default zeros); ``stage``: the partition
    stage (default :func:`partition_stage`).  Returns ``(SolveResult,
    (z_local, v_local))``: the whole tree's result on every rank, and this
    rank's share of the final iterates.  ``stats`` (a dict) gets the
    collectives per iteration and the bytes per rank."""
    from ..algorithms import cp as cp_alg

    sh = Sharded(data, meta, mesh, stage)
    x0, zl, vl = _start(sh, x0, z0, v0, data)
    sh.comm.reset()
    res = cp_alg.run_cp(sh.data, sh.meta, x0, zl, vl, tol, max_iter,
                        gamma=gamma, sigma=sigma, fused_sweep=False,
                        ops=sh.ops)
    if stats is not None:
        _fill_stats(stats, sh, int(res.iterations.max()), res.z, res.v,
                    x0.shape[0], x0.element_size())
    return (dataclasses.replace(res, z=sh.whole(res.z), v=sh.whole(res.v)),
            (res.z, res.v))


def run_sp_sharded(data: ProblemData, meta: ProblemMeta, x0, tol,
                   max_iter: int, mesh: Mesh,
                   opts: Optional[sp_alg.SuperMannOpts] = None, z0=None,
                   v0=None, gamma=None, sigma=None, stats=None,
                   record: bool = False, stage: Optional[int] = None):
    """SuperMann (SPOCK) with node-sharded iterates: the composed iteration
    (``supermann.sp_body``) on this rank's share, every node-shaped field of
    its carry (z, v, r_prev, s_prev, the Anderson rows, the sweep cache) in
    the share's layout and every per-lane scalar replicated.  Anderson or
    "residual" directions (Broyden's flat state is refused).  Arguments and
    returns as :func:`run_cp_sharded`; ``record`` keeps the trace."""
    opts = opts or sp_alg.SuperMannOpts()
    if opts.direction not in ("anderson", "residual"):
        raise ValueError("Broyden keeps a flat [B, K] state: it is not "
                         "node-shardable")
    sh = Sharded(data, meta, mesh, stage)
    x0, zl, vl = _start(sh, x0, z0, v0, data)
    c = sp_alg.sp_init(sh.meta, x0, zl, vl, opts, max_iter=max_iter,
                       record=record)
    body = sp_alg.sp_body(sh.data, sh.meta, tol, opts, gamma=gamma,
                          sigma=sigma, fused_sweep=False, record=record,
                          ops=sh.ops)
    sh.comm.reset()
    while c.it < max_iter and not bool(c.done.all()):
        c = body(c)
    if stats is not None:
        _fill_stats(stats, sh, c.it, c.z, c.v, x0.shape[0],
                    x0.element_size())
    res = SolveResult(
        z=sh.whole(c.z), v=sh.whole(c.v), iterations=c.niter,
        status=torch.where(c.done, 0, 1).to(torch.int32), xi1=c.xi1,
        xi2=c.xi2, residuals=c.hist)
    return res, (c.z, c.v)
