"""Receding-horizon MPC simulation with warm starting.

:func:`simulate` advances B plants in lockstep: at each step it solves from
the current states, applies the root inputs, advances the plants with the
given realizations, and warm-starts the next solve from the previous
primal-dual iterate.  :func:`simulate_async` is the asynchronous farm: each
lane starts its next warm-started solve the moment its current one
converges, so throughput follows the mean iteration count, not the
slowest lane.  The JAX package's ``lax.scan`` is a host loop here.  Its
``lax.while_loop`` is a host loop over chunks of farm iterations
(``_simulate_async_chunk``, the counterpart of ``_simulate_async_jit``),
checked on the host once per chunk: with ``iters_per_launch = K > 0`` a
chunk is K iterations, and on the card with the fused step one replay of a
CUDA graph that holds them (``_ChunkGraph``); with 0 it is one iteration.

``fused_sweep`` chooses the CP sweep of the solvers (see
:mod:`spock_tpu_torch.algorithms.supermann`): one kernel launch per sweep by
default, the composed path when False.  ``fused_step`` (default True) runs
each SuperMann iteration as one step launch and one backtrack launch where
the fused step covers the configuration (``supermann.use_fused_step``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from .algorithms import cp as cp_alg
from .algorithms import supermann as sp_alg
from .ops import spstep, sweep_kernels
from .problem import ProblemData, ProblemMeta
from .solver import check_device, zero_dual, zero_primal
from .utils import profiling
from .zv import tmap


def _plant(data: ProblemData, x, u, w):
    """x+ = A[w] x + B[w] u per lane; x: [B, nx], u: [B, nu], w: [B]."""
    return (torch.matmul(data.A[w], x[..., None])
            + torch.matmul(data.B[w], u[..., None]))[..., 0]


@dataclasses.dataclass(frozen=True)
class MPCResult:
    xs: Any  # [T+1, B, nx] closed-loop states
    us: Any  # [T, B, nu] applied inputs
    iterations: Any  # [T, B] solver iterations per step
    status: Any  # [T, B]
    objective: Any  # [T, B] s_root per step


def simulate(data: ProblemData, meta: ProblemMeta, x0, ws, tol,
             algorithm: str = "spock", max_iter: int = 1000,
             opts: sp_alg.SuperMannOpts = sp_alg.SuperMannOpts(),
             device=None, fused_sweep: bool = True,
             fused_step: bool = True) -> MPCResult:
    """Closed-loop simulation.  x0: [B, nx] initial states; ws: [T, B] int
    realization indices; tol: solver tolerance per step."""
    device = check_device(data, device)
    x = torch.as_tensor(x0, dtype=data.dtype, device=device)
    ws = torch.as_tensor(ws, dtype=torch.int64, device=device)
    B = x.shape[0]
    z = zero_primal(meta, (B,), data.dtype, device)
    v = zero_dual(meta, (B,), data.dtype, device)
    xs, us, iters, status, obj = [x], [], [], [], []
    for w in ws:
        if algorithm == "spock":
            res = sp_alg.run_supermann(data, meta, x, z, v, tol=tol,
                                       max_iter=max_iter, opts=opts,
                                       fused_sweep=fused_sweep,
                                       fused_step=fused_step)
        else:
            res = cp_alg.run_cp(data, meta, x, z, v, tol=tol,
                                max_iter=max_iter, fused_sweep=fused_sweep)
        u0 = res.z.u[:, :, 0]
        x = _plant(data, x, u0, w)
        z, v = res.z, res.v
        xs.append(x)
        us.append(u0)
        iters.append(res.iterations)
        status.append(res.status)
        obj.append(res.z.s[:, 0])
    return MPCResult(xs=torch.stack(xs), us=torch.stack(us),
                     iterations=torch.stack(iters),
                     status=torch.stack(status), objective=torch.stack(obj))


@dataclasses.dataclass(frozen=True)
class AsyncMPCResult:
    steps_done: Any  # [B] MPC steps completed per lane
    iters_per_step: Any  # [T, B] solver iterations per completed step
    us: Any  # [T, B, nu] applied inputs per step
    xs: Any  # [B, nx] final states
    total_iterations: int  # farm iterations executed
    z: Any  # final primal state (chain into another run)
    v: Any  # final dual state
    state: Any = None  # the farm's state: ``resume`` continues it
    # how the call ran: iters_per_launch, graphed, chunks (graph replays),
    # eager_chunks, iterations executed, counted (live) and wasted after
    # the farm finished, captures and their seconds, warm-up seconds
    run: Any = None


# Iterations of a throwaway copy of the farm before a graph's first capture:
# they build and load the kernels, make the kernels' constants and the
# retrial counter (tensors the graph reads, which must outlive it, not come
# from its memory pool) and the side stream's cuBLAS workspace; three cover
# the three history phases.
WARMUP_ITERS = 3
# the graphs of at most this many farms are kept (each holds its carry
# buffers and a memory pool)
MAX_GRAPHED_FARMS = 4

_GRAPHS: dict = {}
_STREAMS: dict = {}


def _bodies(data, meta, tol, opts, fused, fused_sweep):
    """The farm's iteration functions, indexed by it mod len: the fused
    step's three history phases, or one ``sp_body``."""
    if fused:
        # one sp_step_fused and one sp_step_backtrack launch per iteration,
        # the history phase bound to the carry's iteration count
        return [sp_alg.sp_body_fused(data, meta, tol, opts, phase=ph)
                for ph in range(3)]
    return [sp_alg.sp_body(data, meta, tol, opts, fused_sweep=fused_sweep)]


def _advance(data, ws, n_steps, fused, opts, body, st):
    """One farm iteration of the state ``st``, with no host sync of its own
    (``body``'s are its own).  It counts in ``total`` only if a lane was
    live before it; once no lane is, it changes nothing of the result: every
    lane is done, the step keeps z and v of a done lane, and no lane
    finishes."""
    sp = st["sp"]
    step_idx = st["step_idx"]
    iters_rec, us_rec = st["iters_rec"], st["us_rec"]
    T, B = ws.shape
    lanes = torch.arange(B, device=step_idx.device)
    live = (step_idx < n_steps).any()
    sp = body(sp)
    # lanes whose current solve just converged and still have steps to do
    fin = sp.done & (step_idx < n_steps)
    u0 = sp_alg.root_u_carry(sp)
    row = torch.clamp(step_idx, max=T - 1)
    # (row, lane) pairs are distinct: the records are written in place
    iters_rec[row, lanes] += torch.where(fin, sp.niter, 0).to(torch.int32)
    us_rec[row, lanes] += torch.where(fin[:, None], u0, 0.0)
    # plant update with each lane's own realization sequence
    x_next = _plant(data, sp.x0, u0, ws[row, lanes])
    step_idx = step_idx + fin.to(torch.int64)
    # Refill: the plant advances; res0, r_safe, eta and niter reset;
    # cache_valid is cleared (the cached sweep pinned the old x0).  The
    # Anderson memory needs no reset: niter = 0 masks the stale r_prev/s_prev
    # reads, and the Anderson rows older than the current solve drop out by
    # their validity (row j of the newest-first history, or the row of age j
    # of the fused carry, counts iff j <= niter).  The Broyden ring is zeroed
    # per lane.
    repl = dict(
        x0=torch.where(fin[:, None], x_next, sp.x0),
        done=sp.done & ~(fin & (step_idx < n_steps)),
        res0=torch.where(fin[:, None], float("-inf"), sp.res0),
        r_safe=torch.where(fin, float("inf"), sp.r_safe),
        niter=torch.where(fin, 0, sp.niter).to(torch.int32),
        cache_valid=sp.cache_valid & ~fin,
    )
    if not fused:
        repl["eta"] = torch.where(fin, float("inf"), sp.eta)
    if opts.direction == "broyden":
        repl["dirstate"] = tmap(
            lambda a: torch.where(
                fin.reshape(fin.shape + (1,) * (a.ndim - 1)),
                torch.zeros_like(a), a),
            sp.dirstate)
    return dict(sp=dataclasses.replace(sp, **repl), step_idx=step_idx,
                iters_rec=iters_rec, us_rec=us_rec,
                total=st["total"] + live.to(st["total"].dtype))


def _result(state, total_iterations, run=None) -> AsyncMPCResult:
    sp = state["sp"]
    return AsyncMPCResult(
        steps_done=state["step_idx"], iters_per_step=state["iters_rec"],
        us=state["us_rec"], xs=sp.x0, total_iterations=total_iterations,
        z=sp.z, v=sp.v, state=state, run=run)


def _simulate_async_chunk(data, meta, ws, n_steps, opts, n_iters, state,
                          bodies, fused):
    """``n_iters`` farm iterations of ``state`` with no host sync of their
    own, the counterpart of the JAX package's ``_simulate_async_jit``:
    ``n_steps`` and the state's ``total`` are device scalars, and an
    iteration after the last lane's last step changes nothing of the result
    (so one chunk serves any step count, as one compiled program does in
    JAX).  The iteration budget is the caller's: it never runs a chunk past
    ``max_total_iters``.  Returns (AsyncMPCResult, state), the result's
    total_iterations the device scalar."""
    for _ in range(n_iters):
        body = bodies[state["sp"].it % len(bodies)]
        state = _advance(data, ws, n_steps, fused, opts, body, state)
    return _result(state, state["total"]), state


def _live(state, n_steps):
    return (state["step_idx"] < n_steps).any()


def _check(state, n_steps) -> tuple:
    """(total, live) on the host: the one sync of a chunk."""
    with profiling.span("spock.farm.check"):
        total, live = torch.stack(
            [state["total"], _live(state, n_steps).to(torch.int64)]).tolist()
    return total, bool(live)


def _map(f, *states):
    """``f`` over the tensor leaves of farm states (dicts of carries and
    tensors); the carry's ``it`` is the first state's."""
    if isinstance(states[0], dict):
        return {k: _map(f, *(st[k] for st in states)) for k in states[0]}
    return tmap(lambda *a: f(*a) if torch.is_tensor(a[0]) else a[0], *states)


def _counters() -> dict:
    """{(counter holder, key): launches} of every kernel wrapper."""
    from .ops import cuda_kernels

    out = {(cuda_kernels, None): cuda_kernels.LAUNCHES}
    for mod in (spstep, sweep_kernels):
        out.update({(mod, k): c for k, c in mod.LAUNCHES.items()})
    return out


def _add_counts(delta: dict) -> None:
    for (mod, key), n in delta.items():
        if key is None:
            mod.LAUNCHES += n
        else:
            mod.LAUNCHES[key] += n


class _ChunkGraph:
    """K farm iterations from one history phase, captured once as a CUDA
    graph over static carry buffers and replayed: the state is copied into
    the buffers, a replay runs the K iterations on them and writes the carry
    back into them, and ``check`` holds (total, live) for the host's one
    read per chunk.  The launch counts of the wrappers are bumped once per
    captured launch while it is captured; they are set back after the
    capture and each replay adds the captured launches.  ``keep`` holds
    every tensor the captured kernels read besides the buffers."""

    def __init__(self, run, state, n_steps, ws, K, pool, stream, keep):
        self.K = K
        self.keep = keep
        self.static = _map(torch.clone, state)
        self.n_steps = n_steps.clone()
        self.ws = ws.clone()
        self.check = torch.zeros(2, dtype=torch.int64, device=ws.device)
        self.graph = torch.cuda.CUDAGraph()
        before = _counters()
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph, pool=pool, stream=stream):
            out = run(self.ws, self.n_steps, self.static, K)
            _map(lambda dst, src: dst.copy_(src), self.static, out)
            self.check.copy_(torch.stack(
                [out["total"], _live(out, self.n_steps).to(torch.int64)]))
        torch.cuda.synchronize()
        self.capture_s = time.perf_counter() - t0
        after = _counters()
        self.delta = {k: after[k] - before[k] for k in after}
        _add_counts({k: -n for k, n in self.delta.items()})

    def replay(self, state, ws, n_steps, copy_in):
        """One replay from ``state`` (copied into the buffers when
        ``copy_in``); returns the state on the buffers and (total, live)."""
        if copy_in:
            with profiling.span("spock.farm.copy_in"):
                _map(lambda dst, src: dst.copy_(src), self.static, state)
                self.ws.copy_(ws)
                self.n_steps.copy_(n_steps)
        with profiling.span("spock.farm.replay"):
            self.graph.replay()
        _add_counts(self.delta)
        with profiling.span("spock.farm.check"):
            total, live = self.check.tolist()
        sp = dataclasses.replace(self.static["sp"],
                                 it=state["sp"].it + self.K)
        return dict(self.static, sp=sp), (total, bool(live))


def _side_stream(device):
    s = _STREAMS.get(device)
    if s is None:
        s = _STREAMS[device] = torch.cuda.Stream(device)
    return s


def _warm_up(run, state, n_steps, ws, stream):
    """WARMUP_ITERS eager iterations of a copy of the farm on ``stream``,
    whose results, launch counts and retrial counts are thrown away."""
    before = _counters()
    retrials = {d: a.clone() for d, a in spstep.RETRIALS.items()}
    stream.wait_stream(torch.cuda.current_stream(ws.device))
    with torch.cuda.stream(stream):
        run(ws, n_steps, _map(torch.clone, state), WARMUP_ITERS)
    torch.cuda.synchronize()
    after = _counters()
    _add_counts({k: before[k] - after[k] for k in after})
    for d, a in spstep.RETRIALS.items():
        a.copy_(retrials[d]) if d in retrials else a.zero_()


def clear_graphs() -> None:
    """Drop every captured farm graph (and its buffers and memory pool)."""
    _GRAPHS.clear()


def _graphs_for(key, data):
    farm = _GRAPHS.get(key)
    if farm is None or farm["data"] is not data:
        while len(_GRAPHS) >= MAX_GRAPHED_FARMS:
            _GRAPHS.pop(next(iter(_GRAPHS)))
        farm = _GRAPHS[key] = dict(data=data, warm=False, by_phase={},
                                   pool=torch.cuda.graph_pool_handle())
    return farm


def _capture(farm, run, state, n_steps, ws, K, stream, keep, stats):
    """The graph of K farm iterations from ``state``'s history phase, with
    the farm's throwaway warm-up before its first capture; adds to the
    call's ``stats``."""
    if not farm["warm"]:
        with profiling.span("spock.farm.warmup"):
            t0 = time.perf_counter()
            _warm_up(run, state, n_steps, ws, stream)
            stats["warmup_s"] += time.perf_counter() - t0
        farm["warm"] = True
    with profiling.span("spock.farm.capture"):
        g = _ChunkGraph(run, state, n_steps, ws, K, farm["pool"], stream,
                        keep)
    stats["captures"] += 1
    stats["capture_s"] += g.capture_s
    return g


@profiling.spanned("spock.farm.call")
def simulate_async(
    data: ProblemData,
    meta: ProblemMeta,
    x0,
    ws,
    tol,
    n_steps: int,
    opts: sp_alg.SuperMannOpts = sp_alg.SuperMannOpts(),
    max_total_iters: int = 1_000_000,
    z0=None,
    v0=None,
    device=None,
    fused_sweep: bool = True,
    fused_step: bool = True,
    iters_per_launch: int = 0,
    resume=None,
) -> AsyncMPCResult:
    """Asynchronous MPC farm of B lanes, each running ``n_steps`` warm-started
    solves of its own chain.

    x0: [B, nx]; ws: [T, B] realization indices (T >= n_steps); z0/v0: the
    warm start of every lane (default zeros).  Stops when every lane has done
    ``n_steps`` steps or after ``max_total_iters`` farm iterations.

    iters_per_launch = K > 0 runs the farm in chunks of K iterations with
    one host check each: on the card with the fused step, each chunk is one
    replay of a CUDA graph captured once for the farm's shapes and history
    phase (no host sync inside it; a capture or replay that fails raises),
    elsewhere the same iterations eagerly.  A last chunk that the budget
    cuts short runs eagerly.  The iterations of the last chunk after the
    farm finished change nothing of the result.  0: one iteration per check.
    The results are bitwise those of K = 0.  resume: the ``state`` of a
    previous result (continues the same farm; x0, z0 and v0 are then
    unread, and the budget counts the farm's iterations from its start).
    """
    device = check_device(data, device)
    dtype = data.dtype
    x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    ws = torch.as_tensor(ws, dtype=torch.int64, device=device)
    B = x0.shape[0]
    T = ws.shape[0]
    if n_steps > T:
        raise ValueError(f"n_steps={n_steps} exceeds the {T} realization rows")
    if iters_per_launch < 0:
        raise ValueError(f"iters_per_launch={iters_per_launch} < 0")
    fused = sp_alg.use_fused_step(data, meta, opts, fused_sweep, fused_step)
    # the step kernels time their phases while a profiler records (graphs
    # read the flag at each replay)
    spstep.set_phase_timing(device, profiling.recording())
    if resume is None:
        if z0 is None:
            z0 = zero_primal(meta, (B,), dtype, device)
        if v0 is None:
            v0 = zero_dual(meta, (B,), dtype, device)
        sp = (sp_alg.sp_init_fused if fused else sp_alg.sp_init)(
            meta, x0, z0, v0, opts)
        state = dict(
            sp=sp,
            step_idx=torch.zeros((B,), dtype=torch.int64, device=device),
            # records sized by ws, indexed up to n_steps: one chunk (and one
            # graph) serves every step count
            iters_rec=torch.zeros((T, B), dtype=torch.int32, device=device),
            us_rec=torch.zeros((T, B, meta.nu), dtype=dtype, device=device),
            total=torch.zeros((), dtype=torch.int64, device=device),
        )
    else:
        # the records are written in place: the caller's stay as they were
        state = dict(resume, iters_rec=resume["iters_rec"].clone(),
                     us_rec=resume["us_rec"].clone())
    n_steps_t = torch.tensor(n_steps, dtype=torch.int64, device=device)
    bodies = _bodies(data, meta, tol, opts, fused, fused_sweep)

    def run(ws_, n_steps_, st, n):
        return _simulate_async_chunk(data, meta, ws_, n_steps_, opts, n, st,
                                     bodies, fused)[1]

    K = max(iters_per_launch, 1)
    graphed = iters_per_launch > 0 and fused and device.type == "cuda"
    stats = dict(iters_per_launch=iters_per_launch, graphed=graphed,
                 chunks=0, eager_chunks=0, executed=0, captures=0,
                 capture_s=0.0, warmup_s=0.0)
    if graphed:
        farm = _graphs_for((id(data), B, T, float(tol), opts, K, dtype,
                            device), data)
        stream = _side_stream(device)
    total0, live = _check(state, n_steps_t)
    total, on_static = total0, None
    while live and total < max_total_iters:
        n = min(K, max_total_iters - total)
        with profiling.span("spock.farm.chunk"):
            if graphed and n == K:
                phase = state["sp"].it % 3
                g = farm["by_phase"].get(phase)
                if g is None:
                    keep = (bodies, sweep_kernels._consts(data, meta),
                            spstep.retrial_counts(device))
                    g = farm["by_phase"][phase] = _capture(
                        farm, run, state, n_steps_t, ws, K, stream, keep,
                        stats)
                state, (total, live) = g.replay(state, ws, n_steps_t,
                                                copy_in=on_static is not g)
                on_static = g
                stats["chunks"] += 1
            else:
                _, state = _simulate_async_chunk(
                    data, meta, ws, n_steps_t, opts, n, state, bodies, fused)
                total, live = _check(state, n_steps_t)
                on_static = None
                stats["eager_chunks"] += 1
        stats["executed"] += n
    if on_static is not None:
        # later replays rewrite the buffers: the result owns its tensors
        with profiling.span("spock.farm.clone_out"):
            state = _map(torch.clone, state)
    stats["counted"] = total - total0
    stats["wasted"] = stats["executed"] - stats["counted"]
    return _result(state, total, stats)
