"""Scenario-tree topology for a uniform branching factor, in closed form.

The layout is the one the JAX package uses (``spock_tpu/tree.py``), kept
identical so that arrays move between the two packages unchanged:

* node indices are 0-based; the root is node ``0``;
* stage ``t`` occupies the contiguous index range
  ``[stage_offset(t), stage_offset(t+1))`` with
  ``stage_offset(t) = (d**t - 1) // (d - 1)``;
* within stage ``t`` (t >= 1) the k-th children of all stage-(t-1) parents
  form one contiguous block: stage-local index ``k * m + i`` where
  ``m = stage_size(t-1)`` and ``i`` is the parent's stage-local index
  (sibling-major order);
* the realization ("w") index of a node is its sibling index ``k``.

Every parent/child data movement is therefore a contiguous slice or reshape
of the node axis.  The reference's own numbering interleaves the children
instead (child k of parent i at stage-local ``i*d + k``):
:meth:`UniformTree.perm_to_reference` maps one onto the other for flat-layout
interop (``utils.refvec``).  All fields are plain Python ints.

The per-stage operators (``ops.linop``, ``ops.riccati``, ``ops.prox``) read
sizes and offsets from a *layout*: this class, or one rank's share of a
node-sharded tree (``parallel.bigtree.Part``), which holds the same
methods and splits one stage over the ranks.  Where a pass crosses from a
stage to its parents they call :meth:`UniformTree.gather`; from a stage's
parents to it, :meth:`UniformTree.scatter`.  A whole tree holds every
stage, so both are identities.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class UniformTree:
    """Topology of a scenario tree with uniform branching factor ``d``.

    Attributes:
      N: number of stages (the root is stage 0; leaves are stage ``N - 1``).
      d: branching factor (>= 2).
    """

    N: int
    d: int

    def __post_init__(self):
        if self.d <= 1:
            raise ValueError(f"Branching factor d must be > 1, got {self.d}.")
        if self.N <= 1:
            raise ValueError(f"Horizon N must be > 1, got {self.N}.")

    @property
    def n(self) -> int:
        """Total number of nodes, (d^N - 1) / (d - 1)."""
        return (self.d**self.N - 1) // (self.d - 1)

    @property
    def n_leaf(self) -> int:
        """Number of leaf nodes, d^(N-1)."""
        return self.d ** (self.N - 1)

    @property
    def n_nonleaf(self) -> int:
        """Number of non-leaf nodes, (d^(N-1) - 1)/(d - 1)."""
        return (self.d ** (self.N - 1) - 1) // (self.d - 1)

    @property
    def leaf_start(self) -> int:
        """Index of the first leaf node (0-based)."""
        return self.n_nonleaf

    def stage_offset(self, t: int) -> int:
        """Index of the first node of stage ``t`` (0-based, t in [0, N])."""
        return (self.d**t - 1) // (self.d - 1)

    def stage_size(self, t: int) -> int:
        return self.d**t

    def stage_slice(self, t: int) -> slice:
        return slice(self.stage_offset(t), self.stage_offset(t + 1))

    def gather(self, t: int, arrs):
        """Arrays whose last axis is this layout's part of stage ``t`` ->
        each with the whole stage (a list).  The whole tree: as given."""
        return arrs

    def scatter(self, t: int, blocks):
        """Blocks that make up the whole stage ``t`` along the last axis ->
        blocks that make up this layout's part (a list).  The whole tree:
        as given."""
        return blocks

    def stage_of(self, j: int) -> int:
        """Stage index of node ``j``."""
        t = 0
        while self.stage_offset(t + 1) <= j:
            t += 1
        return t

    def parent(self, j: int) -> int:
        if j <= 0:
            raise ValueError("The root has no parent.")
        t = self.stage_of(j)
        loc = j - self.stage_offset(t)
        m = self.stage_size(t - 1)
        return self.stage_offset(t - 1) + loc % m

    def children(self, i: int) -> tuple:
        if i >= self.n_nonleaf:
            raise ValueError(f"Node {i} is a leaf; it has no children.")
        t = self.stage_of(i)
        loc = i - self.stage_offset(t)
        m = self.stage_size(t)
        base = self.stage_offset(t + 1)
        return tuple(base + k * m + loc for k in range(self.d))

    def w(self, j: int) -> int:
        """Realization index of non-root node ``j`` (which (A, B) pair was
        used on the edge parent(j) -> j): its sibling-block index."""
        if j <= 0:
            raise ValueError("The root has no realization index.")
        t = self.stage_of(j)
        loc = j - self.stage_offset(t)
        return loc // self.stage_size(t - 1)

    def perm_to_reference(self) -> np.ndarray:
        """perm[our_id] = reference_id (both 0-based, the reference's child
        k of parent i at stage-local i*d + k).  Stage-major in both."""
        perm = np.zeros(self.n, dtype=np.int64)
        # stage by stage: a node's reference id follows its parent's
        for t in range(1, self.N):
            m = self.stage_size(t - 1)
            off, off_p = self.stage_offset(t), self.stage_offset(t - 1)
            parent_loc = perm[off_p: off_p + m] - off_p  # [m]
            for k in range(self.d):
                perm[off + k * m: off + (k + 1) * m] = (
                    off + parent_loc * self.d + k)
        return perm
