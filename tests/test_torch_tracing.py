"""The port's tracing on the CPU: the host spans of ``utils.profiling``
(recorded only while a profiler records, counted, nested, in the trace),
the farm's chunk spans, the benchmark's readers of the spans and of the
step kernels' phase cycles, and the retrial counter that holds the phase
clock.  The card test (``cuda`` marker, skipped here) holds the step
kernels' outputs bitwise equal with the phase clock on and off."""

import contextlib
import importlib.util
import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from spock_tpu_torch import Solver, build, mpc
from spock_tpu_torch.models import server_heat
from spock_tpu_torch.ops import spstep
from spock_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tiny():
    return build(server_heat.make_spec(N=3, nx=3, d=2), dtype=torch.float64,
                 device="cpu")


@pytest.fixture
def clean():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _x0(B, value=0.3):
    return torch.full((B, 3), value, dtype=torch.float64)


def test_spans_record_nothing_without_a_profiler(tiny, clean):
    assert profiling.span("spock.solve") is profiling.span("x")
    assert Solver.solve.__name__ == "solve"
    assert mpc.simulate_async.__name__ == "simulate_async"
    res = Solver(*tiny, device="cpu").solve(_x0(2), tol=1e-2)
    assert int(res.iterations.max()) > 0
    assert profiling.spans() == {}


@pytest.mark.parametrize("max_iter", [1000, 4])
def test_solve_spans_under_the_profiler(tiny, clean, tmp_path, max_iter):
    """Converged: one spock.sp.sync more than spock.sp.iter (the last read
    stops the loop); at max_iter as many.  The spans nest in spock.solve in
    the exported trace."""
    solver = Solver(*tiny, device="cpu", max_iter=max_iter)
    with profile() as prof:
        res = solver.solve(_x0(2), tol=1e-2)
    table = profiling.spans()
    iters = int(res.iterations.max())
    assert table["spock.sp.iter"][0] == iters
    converged = bool((res.status == 0).all())
    assert converged == (max_iter > iters)
    assert table["spock.sp.sync"][0] == iters + int(converged)
    assert table["spock.solve"][0] == 1
    for count, total, own in table.values():
        assert count > 0 and 0 <= own <= total
    # the solve's self time is what its children do not cover
    kids = table["spock.sp.iter"][1] + table["spock.sp.sync"][1]
    assert table["spock.solve"][2] == table["spock.solve"][1] - kids
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())[
        "traceEvents"] if e.get("name", "").startswith("spock.")]
    root = [e for e in events if e["name"] == "spock.solve"]
    assert len(root) == 1
    t0, t1 = root[0]["ts"], root[0]["ts"] + root[0]["dur"]
    inner = [e for e in events if e["name"] != "spock.solve"]
    assert len(inner) == table["spock.sp.iter"][0] + table["spock.sp.sync"][0]
    assert all(t0 <= e["ts"] and e["ts"] + e["dur"] <= t1 for e in inner)


def test_eager_farm_counts_a_span_a_chunk(tiny, clean):
    """iters_per_launch > 0 on the CPU runs eager chunks: one
    spock.farm.chunk each, under one spock.farm.call, and a check each plus
    the call's first."""
    data, meta = tiny
    ws = torch.randint(0, 2, (2, 3), generator=torch.Generator().manual_seed(0))
    with profile():
        res = mpc.simulate_async(data, meta, _x0(3), ws, 1e-2, n_steps=2,
                                 iters_per_launch=4, device="cpu")
    table = profiling.spans()
    chunks = res.run["eager_chunks"]
    assert chunks > 0 and res.run["chunks"] == 0
    assert table["spock.farm.chunk"][0] == chunks
    assert table["spock.farm.call"][0] == 1
    assert table["spock.farm.check"][0] == chunks + 1
    assert "spock.farm.replay" not in table


def test_retrials_read_the_same_from_the_longer_counter(monkeypatch):
    """retrials() reads words 0-1 only; reset_retrials keeps the phase
    clock's flag; phase_cycles reads the cards' counters alone."""
    acc = torch.tensor([3, 7, 1] + list(range(10, 10 + len(spstep.PHASES))))
    cpu = torch.tensor([2, 5, 0] + [0] * len(spstep.PHASES))
    monkeypatch.setattr(spstep, "RETRIALS", {torch.device("cuda", 0): acc,
                                             torch.device("cpu"): cpu})
    assert spstep.retrials() == (5, 12)
    assert spstep.phase_cycles() == dict(
        zip(spstep.PHASES, range(10, 10 + len(spstep.PHASES))))
    spstep.reset_retrials()
    assert acc.tolist() == [0, 0, 1] + [0] * len(spstep.PHASES)
    assert spstep.retrials() == (0, 0)
    monkeypatch.setattr(spstep, "RETRIALS", {torch.device("cpu"): cpu})
    assert spstep.phase_cycles() is None


def test_cpu_backtrack_adds_to_the_retrial_words(tiny, monkeypatch):
    monkeypatch.setattr(spstep, "RETRIALS", {})
    res = Solver(*tiny, device="cpu").solve(_x0(2, 0.6), tol=1e-3)
    acc = spstep.retrial_counts("cpu")
    assert acc.shape == (3 + len(spstep.PHASES),)
    lanes, trials = spstep.retrials()
    assert 0 < lanes <= trials and acc[2:].tolist() == [0] * (
        1 + len(spstep.PHASES))
    assert int(res.iterations.max()) > 0
    spstep.set_phase_timing("cpu", True)  # no card: nothing to time
    assert acc[2] == 0


def test_step_body_plans_the_phase_clock_words(monkeypatch):
    """The step kernels' instance is chosen on the node plan with the phase
    clock's words at its end (as csrc/sp_step.cu plans it): under a shared
    memory limit that the plain plan meets with fewer than CLOCK_BYTES to
    spare, the sweep kernels keep the node body and the step kernels take
    the element body."""
    from spock_tpu_torch.ops import sweep_kernels

    data, meta = build(server_heat.make_spec(N=3, nx=3, d=2),
                       dtype=torch.float32, device="cpu")
    tail = spstep.CLOCK_BYTES
    plain = sweep_kernels.node_plan(meta, data, 4)
    assert sweep_kernels.node_plan(meta, data, 4, tail=tail) == dict(
        plain, bytes=plain["bytes"] + tail)
    # the least limit that the plain plan meets
    lo, hi = 0, sweep_kernels.SMEM_LIMIT
    while lo < hi:
        mid = (lo + hi) // 2
        monkeypatch.setattr(sweep_kernels, "SMEM_LIMIT", mid)
        if sweep_kernels.node_plan(meta, data, 4) is None:
            lo = mid + 1
        else:
            hi = mid
    monkeypatch.setattr(sweep_kernels, "SMEM_LIMIT", lo + tail - 1)
    assert sweep_kernels.sweep_body(meta, data, torch.float32) == "node"
    assert spstep.step_body(meta, data, torch.float32) == "element"
    monkeypatch.setattr(sweep_kernels, "SMEM_LIMIT", lo + tail)
    assert spstep.step_body(meta, data, torch.float32) == "node"


def _reader(name):
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"tracing_reader_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# a made-up table (ns) and counter, and each reader's reading of them
TABLE = {"spock.sp.iter": [4, 8_000_000, 6_000_000],
         "spock.sp.sync": [5, 20_000_000, 20_000_000],
         "spock.farm.call": [2, 90_000_000, 3_000_000],
         "spock.farm.chunk": [10, 80_000_000, 5_000_000],
         "spock.farm.copy_in": [1, 1_000_000, 1_000_000],
         "spock.farm.replay": [10, 4_000_000, 4_000_000],
         "spock.farm.check": [11, 70_000_000, 70_000_000]}
CYCLES = dict(lprime_s2=100, riccati_backward=300, riccati_forward=200,
              prox_hconj=50, metric=150, anderson=80, commit=70,
              block_total=1000)
READINGS = {
    "sp_enqueue_ms.loop": 2.0, "sp_enqueue_ms.cold": 2.0,
    "farm_chunk_host_ms.farm": 1.0, "farm_call_host_ms.farm": 1.5,
    "sp_riccati_pct.farm": 50.0, "sp_riccati_pct.loop": 50.0,
    "sp_riccati_pct.cold": 50.0, "sp_sweep_pct.farm": 80.0,
    "sp_sweep_pct.loop": 80.0, "sp_sweep_pct.cold": 80.0}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_readers_read_the_spans_and_cycles(name, monkeypatch):
    read = _reader(name)
    monkeypatch.setattr(profiling, "_TABLE",
                        {k: list(v) for k, v in TABLE.items()})
    monkeypatch.setattr(spstep, "phase_cycles", lambda: dict(CYCLES))
    assert read({}) == pytest.approx(READINGS[name])
    # nothing recorded: no reading
    monkeypatch.setattr(profiling, "_TABLE", {})
    monkeypatch.setattr(spstep, "phase_cycles", lambda: None)
    assert read({}) is None
    monkeypatch.setattr(spstep, "phase_cycles",
                        lambda: dict.fromkeys(CYCLES, 0))
    assert read({}) is None


def test_benchmark_entries_of_the_readers():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    cells = {c["name"] for c in bench["workloads"]}
    for name in READINGS:
        m = entries[name]
        assert m["source"] == "program_counter" and m["better"] == "lower"
        assert m["workloads"] and set(m["workloads"]) <= cells
        assert (ROOT / "benchmark" / "metrics" / f"{name}.py").exists()


def _case(data, meta, dtype, B=4):
    """The step kernels' arguments: eight random pairs, x0 and a scalar
    pack with active, cached, first-iteration and inactive lanes."""
    from spock_tpu_torch.ops import sweep_kernels

    gen = torch.Generator().manual_seed(1)

    def pair():
        return sweep_kernels.new_pair(meta, B, lambda s: torch.randn(
            s, generator=gen, dtype=torch.float64).to(dtype).to(data.device))

    pairs = [pair() for _ in range(8)]
    x0 = (torch.rand((B, meta.nx), generator=gen, dtype=torch.float64)
          - 0.5).to(dtype).to(data.device)
    scal = torch.tensor([[1, 0, 0, 0, float("inf"), 1.0, 0, 0, 0, 1.0],
                         [1, 1, 1, 1, 1e3, 0.9, 1e3, 0.5, 0.7, 1.0],
                         [0, 1, 1, 1, 5.0, 0.8, 3.0, 0.5, 0.7, 1.0],
                         [1, 1, 0, 0, 40.0, 0.7, 0, 0, 0, 0.25]],
                        dtype=dtype, device=data.device)
    return (data, meta, *pairs[0], *pairs[1:], x0, scal, 0.21, 0.37)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nx", [5, 33])
def test_step_kernels_bitwise_equal_with_the_phase_clock(nx, dtype):
    """The node (nx = 5) and element (nx = 33) instances: sp_step_fused and
    sp_step_backtrack give the same bits with the phase clock on (their
    launches under a profiler) and off; on, every slot gets cycles and none
    exceeds block_total; off, no cycle is added, also right after a
    profiled launch left the flag on."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from spock_tpu_torch.zv import leaves

    data, meta = build(server_heat.make_spec(N=3, nx=nx, d=2), dtype=dtype)
    assert spstep.step_body(meta, data, dtype) == (
        "node" if nx <= 32 else "element")
    args = _case(data, meta, dtype)
    knobs = dict(c1=0.99, sigma_k2=0.1, lam=1.0, lam_sp=1.0)

    # the kept fresh sweep is written only at the lanes without a cache
    fresh = args[-3][:, spstep.SC_CACHE] == 0

    def run(on):
        spstep.reset_retrials()
        with (profile(activities=[ProfilerActivity.CPU]) if on
              else contextlib.nullcontext()):
            out = spstep.sp_step_fused(*args, **knobs)
            oscal = out[6].clone()
            oscal[:, spstep.OC_LOOP] = 1.0  # every lane backtracks
            z_new, s = out[0], out[3]
            bt = spstep.sp_step_backtrack(data, meta, *args[2:4], out[7],
                                          args[-4], args[-3], oscal, z_new,
                                          s, 0.21, 0.37, 0.5, 3, **knobs)
            torch.cuda.synchronize()
        keep = out[7]
        got = leaves((out[:7], keep.d, keep.scal, bt))
        got += [a[fresh] for a in leaves(keep.fresh)]
        return [a.clone() for a in got], spstep.phase_cycles()

    off, cycles_off = run(False)
    on, cycles_on = run(True)
    again, cycles_again = run(False)
    for a, b, c in zip(off, on, again):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert set(cycles_off.values()) == {0}
    assert set(cycles_again.values()) == {0}
    total = cycles_on["block_total"]
    assert total > 0
    for slot in spstep.PHASES:
        assert 0 < cycles_on[slot] <= total, slot
    assert sum(cycles_on[s] for s in spstep.PHASES[:-1]) <= total
