"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points run on the card unless told otherwise, and its kernel wrappers
never fall back to the plain version for a tensor that is not on the CPU.

This file imports no JAX, so its card test also runs on a machine without
JAX:  python -m pytest tests/test_torch_isolation.py -m cuda --noconftest
-o addopts="" -p no:cacheprovider
"""

import dataclasses
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import spock_tpu_torch
from spock_tpu_torch import build, interop, mpc, problem, risks
from spock_tpu_torch.models import server_heat
from spock_tpu_torch.algorithms import common
from spock_tpu_torch.ops import (
    _build, cuda_kernels, linop, prox, spstep, sweep_kernels)
from spock_tpu_torch.solver import Solver, zero_primal
from spock_tpu_torch.zv import DUAL_BLOCKS, Dual, leaves, tmap

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "spock_tpu_torch"


def test_import_and_solve_load_no_jax():
    code = (
        "import sys, numpy as np, torch\n"
        "import spock_tpu_torch as st\n"
        "import spock_tpu_torch.ops.sweep_kernels\n"
        "import spock_tpu_torch.ops.spstep\n"
        "import spock_tpu_torch.algorithms.broyden\n"
        "from spock_tpu_torch.models import car\n"
        "data, meta = st.build(car.make_spec(N=3, d=2), dtype=torch.float64,"
        " device='cpu')\n"
        "res = st.Solver(data, meta, device='cpu').solve(np.array([.1, .1]),"
        " tol=1e-4)\n"
        "assert bool(res.converged)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or"
        " m.startswith('jax.') or m == 'spock_tpu' or"
        " m.startswith('spock_tpu.'))\n"
        "print('LOADED', bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_native_oracle_loads_no_jax():
    """The jax-free native oracle makes its inputs without loading JAX or
    the JAX package, and names its library under build/spock_tpu_torch/,
    never the tracked native/libspock_cpu.so (its build and solves are held
    in tests/test_torch_native.py)."""
    code = (
        "import sys\n"
        "from spock_tpu_torch.baselines import native\n"
        "from spock_tpu_torch.models import car\n"
        "nat = native.NativeSolver(car.make_spec(N=3, d=2))\n"
        "assert nat.L_sq > 0\n"
        "path = native.library_path()\n"
        "assert path.parent.name == 'spock_tpu_torch', path\n"
        "assert path.parent.parent.name == 'build', path\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or"
        " m.startswith('jax.') or m == 'spock_tpu' or"
        " m.startswith('spock_tpu.'))\n"
        "print('LOADED', bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_oracles_and_utilities_load_no_jax(tmp_path):
    """The EVaR risk, the scipy and ADMM oracles and the utilities load and
    run without JAX or the JAX package: an EVaR projection, an ADMM solve,
    a reference-layout round trip and a checkpoint."""
    code = (
        "import sys, numpy as np, torch\n"
        "from spock_tpu_torch import build, risks\n"
        "from spock_tpu_torch.baselines import admm_ref, scipy_ref\n"
        "from spock_tpu_torch.models import car\n"
        "from spock_tpu_torch.ops import cones\n"
        "from spock_tpu_torch.solver import zero_dual, zero_primal\n"
        "from spock_tpu_torch.utils import checkpoint, profiling, refvec\n"
        "r = risks.evar(np.array([0.3, 0.7]), 0.5, 3)\n"
        "p = cones.project_cone_product(torch.ones(1, r.ny, 3),"
        " risks.dual_cone(r.cone))\n"
        "assert bool(torch.isfinite(p).all())\n"
        "spec = car.make_spec(N=3, d=2)\n"
        "assert admm_ref.solve(spec, np.array([.1, .1]))['converged']\n"
        "data, meta = build(spec, dtype=torch.float64, device='cpu')\n"
        "z = zero_primal(meta, (1,), torch.float64, 'cpu')\n"
        "refvec.primal_from_ref(meta, refvec.primal_to_ref(meta, z))\n"
        "v = zero_dual(meta, (1,), torch.float64, 'cpu')\n"
        f"checkpoint.save_state({str(tmp_path / 's.npz')!r}, z, v)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or"
        " m.startswith('jax.') or m == 'spock_tpu' or"
        " m.startswith('spock_tpu.'))\n"
        "print('LOADED', bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_missing_gxx_raises(monkeypatch, tmp_path):
    """Without g++ the native oracle's library cannot be built: a solve
    raises, and no library is loaded in its place."""
    from spock_tpu_torch.baselines import native
    from spock_tpu_torch.models import car

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    solver = native.NativeSolver(car.make_spec(N=3, d=2))
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        solver.solve(np.array([0.1, 0.1]))
    assert native._LIB is None


def test_sources_import_no_jax():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|spock_tpu)(\.|\s|$)", re.M)
    files = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        assert not pattern.search(f.read_text()), f


def test_launch_counts_survive_threads():
    """The wrappers' launch counts take every increment when many host
    threads launch at once (chip_smoke.py runs config 3's rows so)."""
    threads, per = 16, 2000
    before = (cuda_kernels.LAUNCHES, sweep_kernels.LAUNCHES["cp_sweep_fused"],
              spstep.LAUNCHES["sp_step_fused"])

    def work():
        for _ in range(per):
            cuda_kernels._count()
            sweep_kernels.count(sweep_kernels.LAUNCHES, "cp_sweep_fused")
            sweep_kernels.count(spstep.LAUNCHES, "sp_step_fused")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    after = (cuda_kernels.LAUNCHES, sweep_kernels.LAUNCHES["cp_sweep_fused"],
             spstep.LAUNCHES["sp_step_fused"])
    assert [a - b for a, b in zip(after, before)] == [threads * per] * 3
    cuda_kernels.LAUNCHES = before[0]
    sweep_kernels.LAUNCHES["cp_sweep_fused"] = before[1]
    spstep.LAUNCHES["sp_step_fused"] = before[2]


def test_tf32_is_off():
    assert spock_tpu_torch.__version__
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def cpu_problem():
    return build(server_heat.make_spec(N=3, nx=3, d=2), dtype=torch.float64,
                 device="cpu")


@pytest.mark.parametrize("entry", ["build", "Solver", "simulate_async",
                                   "interop"])
def test_entry_points_default_to_the_card(no_cuda, cpu_problem, entry):
    """Without a device argument and without a card, every entry point
    raises instead of carrying on on the CPU."""
    data, meta = cpu_problem
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "build":
            build(server_heat.make_spec(N=3, nx=3, d=2))
        elif entry == "Solver":
            Solver(data, meta)
        elif entry == "interop":
            interop.primal_from_numpy(zero_primal(meta, (1,), torch.float64,
                                                  "cpu"))
        else:
            mpc.simulate_async(data, meta, np.zeros((1, 3)),
                               np.zeros((1, 1), int), 1e-3, n_steps=1)


def test_mesh_defaults_to_the_card(no_cuda):
    """Without a card and without device="cpu", a mesh and a job raise
    (NCCL is never swapped for gloo); the raise comes before any store is
    contacted."""
    from spock_tpu_torch.parallel import mesh as pmesh

    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.init_distributed("127.0.0.1:1", num_processes=2, process_id=0)


def test_parallel_modules_load_no_jax():
    """The distribution layer loads and runs without JAX or the JAX package:
    a one-rank gloo mesh, a node-sharded CP solve at a forced stage and a
    lane gather."""
    code = (
        "import sys, numpy as np, torch\n"
        "import spock_tpu_torch.parallel\n"
        "from spock_tpu_torch import build\n"
        "from spock_tpu_torch.models import car\n"
        "from spock_tpu_torch.parallel import bigtree, mesh\n"
        "data, meta = build(car.make_spec(N=3, d=2), dtype=torch.float64,"
        " device='cpu')\n"
        "m = mesh.make_mesh(device='cpu')\n"
        "res, _ = bigtree.run_cp_sharded(data, meta, np.array([[.1, .1]]),"
        " 1e-4, 50, m, stage=1)\n"
        "assert res.z.x.shape[-1] == meta.tree.n\n"
        "mesh.gather_batch(res.status, m)\n"
        "bad = sorted(x for x in sys.modules if x == 'jax' or"
        " x.startswith('jax.') or x == 'spock_tpu' or"
        " x.startswith('spock_tpu.'))\n"
        "print('LOADED', bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_entry_point_rejects_data_on_another_device(cpu_problem):
    data, meta = cpu_problem
    with pytest.raises(ValueError, match="lives on"):
        Solver(data, meta, device="meta")


def _meta_dual(meta, B, dtype=torch.float32):
    shapes = cuda_kernels.block_shapes(meta, B)
    return Dual(**{k: torch.empty(shapes[k], dtype=dtype, device="meta")
                   for k in DUAL_BLOCKS})


def test_kernel_wrapper_never_falls_back(cpu_problem):
    """A tensor that is not on the CPU goes to the kernel or raises; the
    plain version is taken for CPU tensors only."""
    data, meta = cpu_problem
    before = cuda_kernels.LAUNCHES
    with pytest.raises(ValueError, match="prox_h_conj kernel"):
        cuda_kernels.prox_h_conj_fused(data, meta, _meta_dual(meta, 2), 0.3)
    assert cuda_kernels.LAUNCHES == before


def _meta_pair(meta, B, dtype=torch.float32):
    return sweep_kernels.new_pair(
        meta, B, lambda s: torch.empty(s, dtype=dtype, device="meta"))


SWEEP_CALLS = {
    "cp_sweep_fused": lambda f, d, m, z, v, x0, tau: f(d, m, z, v, 0.2, 0.3,
                                                       x0),
    "cp_sweep_metric_fused": lambda f, d, m, z, v, x0, tau: f(
        d, m, z, v, 0.2, 0.3, x0),
    "candidate_sweep_fused": lambda f, d, m, z, v, x0, tau: f(
        d, m, z, v, z, v, tau, 0.2, 0.3, x0),
    "metric_apply_fused": lambda f, d, m, z, v, x0, tau: f(d, m, z, v, 0.2,
                                                           0.3),
}


@pytest.mark.parametrize("name", list(SWEEP_CALLS))
def test_sweep_wrappers_never_fall_back(cpu_problem, name):
    """Tensors that are not on the CPU go to the sweep kernels or raise."""
    data, meta = cpu_problem
    z, v = _meta_pair(meta, 2, torch.float64)
    x0 = torch.empty((2, meta.nx), dtype=torch.float64, device="meta")
    tau = torch.empty((2,), dtype=torch.float64, device="meta")
    before = dict(sweep_kernels.LAUNCHES)
    with pytest.raises(ValueError, match=f"{name} kernel"):
        SWEEP_CALLS[name](getattr(sweep_kernels, name), data, meta, z, v, x0,
                          tau)
    assert sweep_kernels.LAUNCHES == before


def test_step_wrapper_never_falls_back(cpu_problem):
    """Tensors that are not on the CPU go to the step kernel or raise."""
    data, meta = cpu_problem
    pairs = [_meta_pair(meta, 2, torch.float64) for _ in range(8)]
    x0 = torch.empty((2, meta.nx), dtype=torch.float64, device="meta")
    scal = torch.empty((2, spstep.N_SC), dtype=torch.float64, device="meta")
    before = dict(spstep.LAUNCHES)
    with pytest.raises(ValueError, match="sp_step_fused kernel"):
        spstep.sp_step_fused(data, meta, *pairs[0], *pairs[1:], x0, scal, 0.2,
                             0.3, c1=0.99, sigma_k2=0.1, lam=1.0, lam_sp=1.0)
    assert spstep.LAUNCHES == before


def _meta_keep(meta, B):
    return spstep.StepKeep(
        cache=_meta_pair(meta, B, torch.float64),
        fresh=_meta_pair(meta, B, torch.float64),
        d=_meta_pair(meta, B, torch.float64),
        scal=torch.empty((B, spstep.N_KEEP), dtype=torch.float64,
                         device="meta"))


def _retrial(data, meta):
    z, v = _meta_pair(meta, 2, torch.float64)
    x0 = torch.empty((2, meta.nx), dtype=torch.float64, device="meta")
    scal = torch.empty((2, spstep.N_SC), dtype=torch.float64, device="meta")
    oscal = torch.empty((2, spstep.N_OC), dtype=torch.float64, device="meta")
    return spstep.sp_step_backtrack(
        data, meta, z, v, _meta_keep(meta, 2), x0, scal, oscal,
        _meta_pair(meta, 2, torch.float64), _meta_pair(meta, 2, torch.float64),
        0.2, 0.3, 0.5, 8, c1=0.99, sigma_k2=0.1, lam=1.0, lam_sp=1.0)


def test_retrial_wrapper_never_falls_back(cpu_problem):
    """Tensors that are not on the CPU go to the backtrack kernel or
    raise."""
    data, meta = cpu_problem
    before = dict(spstep.LAUNCHES)
    with pytest.raises(ValueError, match="sp_step_backtrack kernel"):
        _retrial(data, meta)
    assert spstep.LAUNCHES == before


def _per_node_costs(data, meta):
    t = meta.tree

    def per_node(a, k):
        return a.expand((k,) + tuple(a.shape[1:])).contiguous()

    return dataclasses.replace(data, sqrtQ=per_node(data.sqrtQ, t.n - 1),
                               sqrtR=per_node(data.sqrtR, t.n - 1),
                               sqrtQN=per_node(data.sqrtQN, t.n_leaf))


def test_step_wrapper_raises_on_per_node_costs(cpu_problem):
    """The step kernel's class has uniform costs only: with per-node costs
    a call on tensors that are not on the CPU raises, never taking the
    plain version."""
    data, meta = cpu_problem
    data = _per_node_costs(data, meta)
    assert sweep_kernels.supported(meta, data)
    assert not spstep.supported(meta, data)
    pairs = [_meta_pair(meta, 2, torch.float64) for _ in range(8)]
    x0 = torch.empty((2, meta.nx), dtype=torch.float64, device="meta")
    scal = torch.empty((2, spstep.N_SC), dtype=torch.float64, device="meta")
    before = dict(spstep.LAUNCHES)
    with pytest.raises(ValueError, match="sp_step_fused kernel: unsupported"):
        spstep.sp_step_fused(data, meta, *pairs[0], *pairs[1:], x0, scal, 0.2,
                             0.3, c1=0.99, sigma_k2=0.1, lam=1.0, lam_sp=1.0)
    assert spstep.LAUNCHES == before


def test_step_class_ends_at_32_states():
    """The step kernels hold a node's column in registers: nx, nu and the
    polytope rows of a node are at most 32.  Wider problems are in the sweep
    kernels' class but not in the step kernels', so the SuperMann iteration
    takes the per-sweep kernels, and a step call on tensors that are not on
    the CPU raises."""
    from spock_tpu_torch.algorithms import supermann as sp

    for nx, inside in ((32, True), (33, False)):
        data, meta = build(server_heat.make_spec(N=2, nx=nx, d=2),
                           dtype=torch.float64, device="cpu")
        assert sweep_kernels.supported(meta, data)
        assert spstep.supported(meta, data) == inside
        assert sp.use_fused_step(data, meta, sp.SuperMannOpts()) == inside
    pairs = [_meta_pair(meta, 2, torch.float64) for _ in range(8)]
    x0 = torch.empty((2, meta.nx), dtype=torch.float64, device="meta")
    scal = torch.empty((2, spstep.N_SC), dtype=torch.float64, device="meta")
    before = dict(spstep.LAUNCHES)
    with pytest.raises(ValueError, match="sp_step_fused kernel: unsupported"):
        spstep.sp_step_fused(data, meta, *pairs[0], *pairs[1:], x0, scal, 0.2,
                             0.3, c1=0.99, sigma_k2=0.1, lam=1.0, lam_sp=1.0)
    assert spstep.LAUNCHES == before


def test_retrial_wrapper_raises_on_per_node_costs(cpu_problem):
    """The backtrack kernel has the step kernel's class: with per-node costs
    a call on tensors that are not on the CPU raises."""
    data, meta = cpu_problem
    data = _per_node_costs(data, meta)
    before = dict(spstep.LAUNCHES)
    with pytest.raises(ValueError,
                       match="sp_step_backtrack kernel: unsupported"):
        _retrial(data, meta)
    assert spstep.LAUNCHES == before


@pytest.mark.parametrize("name", list(SWEEP_CALLS))
def test_sweep_wrappers_raise_on_an_unsupported_class(cpu_problem, name):
    """A second-order risk cone is outside the sweep kernels' class: a call
    on tensors that are not on the CPU raises."""
    data, meta = cpu_problem
    meta = dataclasses.replace(meta, cone=(("soc", meta.ny),))
    z, v = _meta_pair(meta, 2, torch.float64)
    x0 = torch.empty((2, meta.nx), dtype=torch.float64, device="meta")
    tau = torch.empty((2,), dtype=torch.float64, device="meta")
    before = dict(sweep_kernels.LAUNCHES)
    with pytest.raises(ValueError, match=f"{name} kernel: unsupported"):
        SWEEP_CALLS[name](getattr(sweep_kernels, name), data, meta, z, v, x0,
                          tau)
    assert sweep_kernels.LAUNCHES == before


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library("prox_h_conj")


def test_kernel_support_follows_the_problem_class(cpu_problem):
    from spock_tpu_torch.problem import ProblemMeta
    from spock_tpu_torch.tree import UniformTree

    base = dict(tree=UniformTree(N=3, d=2), nx=2, nu=1, ny=5, nf=2)
    assert cuda_kernels.supported(ProblemMeta(
        cone=(("nonneg", 4), ("zero", 1)), **base))
    assert not cuda_kernels.supported(ProblemMeta(
        cone=(("soc", 5),), **base))
    assert not cuda_kernels.supported(ProblemMeta(
        cone=(("nonneg", 4), ("zero", 1)), nc_nl=2, **base))
    assert cuda_kernels.cone_segments((("nonneg", 4), ("reals", 1))) == (
        ("nonneg", 0, 4), ("reals", 4, 5))
    # the sweep kernels: polyhedral cones with polytope rows, per-node
    # costs and per-node risk; the step kernel: the same with uniform costs
    data, meta = cpu_problem
    assert sweep_kernels.supported(meta, data)
    assert spstep.supported(meta, data)
    assert not sweep_kernels.supported(
        dataclasses.replace(meta, cone=(("soc", 5),)), data)
    assert not spstep.supported(
        dataclasses.replace(meta, cone=(("soc", 5),)), data)
    assert sweep_kernels.supported(dataclasses.replace(meta, nc_nl=2), data)
    assert spstep.supported(dataclasses.replace(meta, nc_nl=2), data)
    per_node_q = data.sqrtQ.expand((meta.tree.n - 1,) + data.sqrtQ.shape[1:])
    assert sweep_kernels.supported(
        meta, dataclasses.replace(data, sqrtQ=per_node_q))
    assert not spstep.supported(
        meta, dataclasses.replace(data, sqrtQ=per_node_q))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain_version_on_the_card(dtype):
    """The CUDA kernel against its plain version at a small size (the
    headline size is held in chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    data, meta = build(server_heat.make_spec(N=4, nx=5, d=2), dtype=dtype)
    rng = np.random.default_rng(0)
    shapes = cuda_kernels.block_shapes(meta, 3)
    v = Dual(**{k: torch.tensor(rng.standard_normal(shapes[k]), dtype=dtype,
                                device="cuda") for k in DUAL_BLOCKS})
    before = cuda_kernels.LAUNCHES
    got = cuda_kernels.prox_h_conj_fused(data, meta, v, 0.37)
    ref = prox.prox_h_conj(data, meta, v, 0.37)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES == before + 1
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    for k in DUAL_BLOCKS:
        g, r = getattr(got, k), getattr(ref, k)
        assert float((g - r).abs().max()) <= rtol * (1 + float(r.abs().max())), k


PLAIN = {
    "cp_sweep_fused": lambda d, m, z, v, dz, dv, x0, tau: common.cp_sweep_ref(
        d, m, z, v, 0.21, 0.37, x0),
    "cp_sweep_metric_fused": lambda d, m, z, v, dz, dv, x0, tau: (
        common.cp_sweep_metric_ref(d, m, z, v, 0.21, 0.37, x0)),
    "candidate_sweep_fused": lambda d, m, z, v, dz, dv, x0, tau: (
        common.candidate_sweep_ref(d, m, z, v, dz, dv, tau, 0.21, 0.37, x0)),
    "metric_apply_fused": lambda d, m, z, v, dz, dv, x0, tau: (
        linop.metric_apply(d, m, z, v, 0.21, 0.37)),
}
FUSED = {
    "cp_sweep_fused": lambda d, m, z, v, dz, dv, x0, tau: (
        sweep_kernels.cp_sweep_fused(d, m, z, v, 0.21, 0.37, x0)),
    "cp_sweep_metric_fused": lambda d, m, z, v, dz, dv, x0, tau: (
        sweep_kernels.cp_sweep_metric_fused(d, m, z, v, 0.21, 0.37, x0)),
    "candidate_sweep_fused": lambda d, m, z, v, dz, dv, x0, tau: (
        sweep_kernels.candidate_sweep_fused(d, m, z, v, dz, dv, tau, 0.21,
                                            0.37, x0)),
    "metric_apply_fused": lambda d, m, z, v, dz, dv, x0, tau: (
        sweep_kernels.metric_apply_fused(d, m, z, v, 0.21, 0.37)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", list(FUSED))
def test_sweep_kernel_matches_plain_version_on_the_card(name, dtype):
    """Each sweep kernel against its plain version at a small size.  float64:
    within 1e-9.  float32: within 1e-5 (1 + max|plain|) per output, since the
    kernel sums the per-lane reductions and the matrix rows in another order
    than PyTorch, over up to ~1e3 terms per lane here."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _sweep_check(server_heat.make_spec(N=4, nx=5, d=2), name, dtype)


def _wide_spec(per_node_costs):
    """server_heat N=4 nx=5 with per-node AV@R, two-sided polytope rows on
    the non-leaf and leaf nodes, and with ``per_node_costs`` per-node Q, R
    and QN: the widened kernels' class."""
    spec = server_heat.make_spec(N=4, nx=5, d=2)
    t, nx = spec.tree, 5
    rng = np.random.default_rng(5)
    risk = risks.avar_nonuniform(rng.dirichlet(np.ones(2), t.n_nonleaf),
                                 rng.uniform(0.7, 0.99, t.n_nonleaf))
    ones = np.ones((1, nx)) / nx
    poly = problem.Polytope(
        Gx=np.concatenate([ones, np.eye(nx)[:1] - np.eye(nx)[1:2]]),
        Gu=np.concatenate([0.5 * ones, 0.5 * np.eye(nx)[:1]]),
        lo=np.array([-0.2, -0.4]), hi=np.array([0.2, 0.4]),
        GxN=ones, loN=np.array([-0.15]), hiN=np.array([0.15]))
    spec = dataclasses.replace(spec, risk=risk, polytope=poly)
    if per_node_costs:
        def diag(k, scale):
            return np.stack([np.diag(rng.uniform(0.5, 1.5, nx)) * scale
                             for _ in range(k)])

        spec = dataclasses.replace(spec, cost=problem.Cost(
            Q=diag(t.n - 1, 0.1), R=diag(t.n - 1, 1.0),
            QN=diag(t.n_leaf, 0.1)))
    return spec


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", list(FUSED))
def test_widened_sweep_kernel_matches_plain_version_on_the_card(name, dtype):
    """Each sweep kernel against its plain version on per-node risk,
    per-node costs and polytope rows at once, with the tolerances of the
    uniform test above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = _wide_spec(per_node_costs=True)
    _sweep_check(spec, name, dtype)


def _sweep_check(spec, name, dtype):
    data, meta = build(spec, dtype=dtype)
    assert sweep_kernels.supported(meta, data)
    rng = np.random.default_rng(0)

    def pair():
        return sweep_kernels.new_pair(meta, 3, lambda s: torch.tensor(
            rng.standard_normal(s), dtype=dtype, device="cuda"))

    (z, v), (dz, dv) = pair(), pair()
    x0 = torch.tensor(rng.standard_normal((3, meta.nx)), dtype=dtype,
                      device="cuda")
    tau = torch.tensor(rng.random(3), dtype=dtype, device="cuda")
    before = sweep_kernels.LAUNCHES[name]
    got = leaves(FUSED[name](data, meta, z, v, dz, dv, x0, tau))
    torch.cuda.synchronize()
    assert sweep_kernels.LAUNCHES[name] == before + 1
    ref = leaves(PLAIN[name](data, meta, z, v, dz, dv, x0, tau))
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        err = float((g - r).abs().max())
        if dtype == torch.float64:
            assert err <= 1e-9, i
        else:
            assert err <= 1e-5 * (1 + float(r.abs().max())), i


def _step_case(meta, dtype, device, B=4):
    """Eight random pairs, x0 and a scalar pack with a mix of active, cached,
    first-iteration and retrial lanes."""
    rng = np.random.default_rng(1)

    def pair():
        return sweep_kernels.new_pair(meta, B, lambda s: torch.tensor(
            rng.standard_normal(s), dtype=dtype, device=device))

    pairs = [pair() for _ in range(8)]
    x0 = torch.tensor(rng.uniform(-0.5, 0.5, (B, meta.nx)), dtype=dtype,
                      device=device)
    scal = torch.tensor([[1, 0, 0, 0, np.inf, 1.0, 0, 0, 0, 1.0],
                         [1, 1, 1, 1, 1e3, 0.9, 1e3, 0.5, 0.7, 1.0],
                         [0, 1, 1, 1, 5.0, 0.8, 3.0, 0.5, 0.7, 1.0],
                         [1, 1, 0, 0, 40.0, 0.7, 0, 0, 0, 0.25]],
                        dtype=dtype, device=device)
    return pairs, x0, scal


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_step_kernel_matches_plain_version_on_the_card(dtype):
    """The SuperMann step kernel against sp_step_ref at a small size, its
    kept direction and scalars included, then the backtrack kernel on a
    strict subset of the lanes against sp_backtrack_ref.  float64: every
    output within 1e-9 (1 + max|plain|).  float32: the K1 / K2 / loop
    decisions of each lane, and on the lanes whose decisions agree every
    output within 1e-4 (1 + max|plain|): two sweeps, the Gram sums and the
    3x3 solve in another order than PyTorch's, and a decision near its
    threshold may flip in float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _step_check(*build(server_heat.make_spec(N=4, nx=5, d=2), dtype=dtype),
                dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_widened_step_kernel_matches_plain_version_on_the_card(dtype):
    """The step and backtrack kernels against their plain versions on
    per-node risk and polytope rows (their class has uniform costs), with
    the tolerances of the uniform test above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _step_check(*build(_wide_spec(per_node_costs=False), dtype=dtype), dtype)


@pytest.mark.cuda
def test_step_kernels_with_costates_in_device_memory_on_the_card():
    """server_heat N=11 nx=20 d=2 in float64: a lane's Riccati costates
    (245,760 bytes) do not fit in a block's shared memory, so the step
    kernels keep them in device memory; both entries against their plain
    versions, with the float64 tolerance of the uniform test above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    data, meta = build(server_heat.make_spec(N=11, nx=20, d=2),
                       dtype=torch.float64)
    plan = spstep.smem_plan(data, meta, torch.float64)
    assert not plan["costates_in_shared_memory"]
    _step_check(data, meta, torch.float64)


@pytest.mark.cuda
def test_step_kernels_launch_on_a_second_card():
    """The step kernels launch on the first card, then on the second: their
    blocks take more than the default 48 KB of shared memory, a limit that
    each device lifts on its own.  server_heat N=8 nx=20 d=2 in float64
    (costates of 61,440 bytes in shared memory)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    spec = server_heat.make_spec(N=8, nx=20, d=2)
    for device in ("cuda:0", "cuda:1"):
        data, meta = build(spec, dtype=torch.float64, device=device)
        assert spstep.smem_plan(data, meta, torch.float64)["bytes"] > 48 * 1024
        _step_check(data, meta, torch.float64, device)


def _hold(got, ref, dtype, lanes=None):
    """Each output leaf within 1e-9 (1 + max|plain|) in float64; in float32
    the K1 / K2 / loop decisions of at least all but one lane, and 1e-4
    (1 + max|plain|) on the lanes whose decisions agree.  ``got`` and
    ``ref`` end with the output scalars, of every lane or, with ``lanes``,
    of those lanes (the pairs have every lane)."""
    agree = (got[-1][:, :3] == ref[-1][:, :3]).all(dim=1)
    if dtype == torch.float64:
        assert bool(agree.all())
    else:
        assert int(agree.sum()) >= agree.numel() - 1
    rows = agree
    if lanes is not None:
        rows = torch.ones(leaves(got[0])[0].shape[0], dtype=torch.bool,
                          device=agree.device)
        rows[lanes[~agree]] = False
    pairs = [(g[rows], r[rows])
             for g, r in zip(leaves(got[:-1]), leaves(ref[:-1]))]
    rtol = 1e-9 if dtype == torch.float64 else 1e-4
    for i, (g, r) in enumerate(pairs + [(got[-1][agree], ref[-1][agree])]):
        # r_safe stays inf on a lane that never took K1: equal values agree
        err = torch.where(g == r, 0.0, (g - r).abs())
        assert not bool(err.isnan().any()), i
        scale = float(r[torch.isfinite(r)].abs().max())
        assert float(err.max()) <= rtol * (1 + scale), i


def _step_check(data, meta, dtype, device="cuda"):
    assert spstep.supported(meta, data)
    pairs, x0, scal = _step_case(meta, dtype, device)
    args = (data, meta, *pairs[0], *pairs[1:], x0, scal, 0.21, 0.37)
    knobs = dict(c1=0.99, sigma_k2=0.1, lam=1.0, lam_sp=1.0)
    before = dict(spstep.LAUNCHES)
    got = spstep.sp_step_fused(*args, **knobs)
    torch.cuda.synchronize(device)
    assert spstep.LAUNCHES["sp_step_fused"] == before["sp_step_fused"] + 1
    ref = spstep.sp_step_ref(*args, **knobs)
    # the six pairs, the kept direction and scalars, the output scalars
    _hold((*got[:6], got[7].d, got[7].scal, got[6]),
          (*ref[:6], ref[7].d, ref[7].scal, ref[6]), dtype)

    # the backtracking of a strict subset of the lanes (3 and 0), marked
    # looping in the tau = 1 launch's scalars: up to 3 trials each at tau =
    # 0.5, 0.25, 0.125 on the kept zbar and d, in place into z_new and s
    oscal = got[6].clone()
    oscal[:, spstep.OC_LOOP] = torch.tensor([1, 0, 0, 1], dtype=dtype,
                                            device=device)
    z_new, s = got[0], got[3]
    z_plain, s_plain = tmap(torch.clone, z_new), tmap(torch.clone, s)
    counts = spstep.retrial_counts(device).clone()
    out = spstep.sp_step_backtrack(data, meta, *pairs[0], got[7], x0, scal,
                                   oscal, z_new, s, 0.21, 0.37, 0.5, 3,
                                   **knobs)
    torch.cuda.synchronize(device)
    assert (spstep.LAUNCHES["sp_step_backtrack"]
            == before["sp_step_backtrack"] + 1)
    out_ref, trials = spstep.sp_backtrack_ref(
        data, meta, *pairs[0], got[7], x0, scal, oscal, z_plain, s_plain,
        0.21, 0.37, 0.5, 3, **knobs)
    # every lane, the untouched ones included
    _hold((z_new, s, out), (z_plain, s_plain, out_ref), dtype)
    # the device counter: the two lanes and their trials
    added = (spstep.retrial_counts(device) - counts).tolist()
    got_trials = out[:, spstep.OC_TRIALS].long()
    assert added == [2, int(got_trials.sum())]
    assert got_trials.tolist()[1:3] == [0, 0]
    if dtype == torch.float64:
        assert got_trials.tolist() == trials.tolist()
