"""Processes, meshes and lane sharding on ``torch.distributed``.

The JAX package's distribution model (``spock_tpu/parallel/mesh.py``) with
the communication said out loud, since PyTorch has no GSPMD:

* **lane ("batch") axis**: independent MPC solves split over the ranks of a
  mesh, one process per card.  :func:`shard_batch` gives a rank its
  contiguous block of lanes, :func:`replicate` puts the problem data on its
  device, and :func:`gather_batch` collects the whole batch, in lane order,
  on every rank afterwards.  Lanes are independent, so no collective runs
  inside a lane-sharded loop: each rank runs the ordinary ``Solver`` or
  ``mpc.simulate_async`` (CUDA-graph chunks included) on its own lanes and
  stops when they are done.  Each lane gets the result of the unsharded
  run, because a done lane is frozen in both packages.
* **node axis**: ``parallel.bigtree`` splits one large tree over the ranks
  of a mesh; its boundary exchange and reductions go through the mesh's
  process group.

A mesh always has a process group: NCCL on the card, gloo only when the
caller asks for the CPU.  Several processes join through
:func:`init_distributed`; a single process makes a one-rank group over a
store in its own memory, so that a one-card run sends every collective
through NCCL as a multi-card run would.

The JAX package's ``shard_nodes`` and ``node_constrainer`` have no
counterpart: they place arrays for GSPMD, and ``parallel.bigtree`` places
its iterates and says where its communication goes itself.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..problem import resolve_device
from ..zv import tmap

TIMEOUT = datetime.timedelta(minutes=10)


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _rank_device(device) -> torch.device:
    """The caller's device (default: the card), with the card's index."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device=None):
    """Join ``num_processes`` processes into one job (no-op for <= 1).

    ``coordinator``: ``host:port`` of rank 0's store (``127.0.0.1:<port>``
    on one machine).  On the card (the default) the group is NCCL and each
    process takes card ``process_id % device_count``; ``device="cpu"``
    makes it gloo.  Without a card and without ``device="cpu"`` it raises.
    """
    if num_processes is None or num_processes <= 1:
        return
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(_backend(device),
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of one axis: its name, process group, this process's rank,
    the number of ranks and this rank's device."""

    axis: str
    group: Any
    rank: int
    size: int
    device: torch.device


def make_mesh(n_devices: Optional[int] = None, axis: str = "batch",
              device=None) -> Mesh:
    """A mesh over the job's first ``n_devices`` ranks (default: all).

    ``device``: None means the card (NCCL), ``"cpu"`` the CPU (gloo); with
    neither a card nor ``"cpu"`` it raises.  In a process that is not part
    of a job, the mesh is a one-rank group over a store in this process's
    memory (no network)."""
    device = _rank_device(device)
    backend = _backend(device)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"a process alone makes a one-rank mesh, not {n_devices}: "
                "start a process per rank and call init_distributed")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=TIMEOUT)
    size = dist.get_world_size()
    n = size if n_devices is None else int(n_devices)
    if not 1 <= n <= size:
        raise ValueError(f"{n} ranks asked of a job of {size}")
    if n == size and dist.get_backend() == backend:
        group = dist.group.WORLD
    else:
        group = dist.new_group(list(range(n)), backend=backend,
                               timeout=TIMEOUT)
    if dist.get_rank() >= n:
        raise ValueError(f"rank {dist.get_rank()} is outside a mesh of {n}")
    return Mesh(axis=axis, group=group, rank=dist.get_rank(group), size=n,
                device=device)


def _tensor(a, device):
    if isinstance(a, np.ndarray):
        a = torch.as_tensor(a)
    return a.to(device) if torch.is_tensor(a) else a


def shard_batch(tree, mesh: Mesh):
    """This rank's contiguous block of lanes of every leaf (the leading
    dim), on its device; the batch must divide evenly over the ranks."""

    def take(a):
        a = _tensor(a, mesh.device)
        if not torch.is_tensor(a):
            return a
        B = a.shape[0]
        if B % mesh.size:
            raise ValueError(f"{B} lanes do not split evenly over "
                             f"{mesh.size} ranks")
        per = B // mesh.size
        return a[mesh.rank * per:(mesh.rank + 1) * per]

    return tmap(take, tree)


def replicate(tree, mesh: Mesh):
    """Every leaf on this rank's device (the problem data)."""
    return tmap(lambda a: _tensor(a, mesh.device), tree)


def gather_batch(tree, mesh: Mesh):
    """The whole batch of every leaf, in lane order, on every rank: the
    ranks' blocks of :func:`shard_batch` put back together."""

    def gather(a):
        if not torch.is_tensor(a):
            return a
        flag = a.dtype == torch.bool
        a = (a.to(torch.uint8) if flag else a).to(mesh.device).contiguous()
        parts = [torch.empty_like(a) for _ in range(mesh.size)]
        dist.all_gather(parts, a, group=mesh.group)
        out = torch.cat(parts, dim=0)
        return out.to(torch.bool) if flag else out

    return tmap(gather, tree)
