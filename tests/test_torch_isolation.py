"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points run on the card unless told otherwise, and its kernel wrapper
never falls back to the plain version for a tensor that is not on the CPU.

This file imports no JAX, so its card test also runs on a machine without
JAX:  python -m pytest tests/test_torch_isolation.py -m cuda --noconftest
-o addopts="" -p no:cacheprovider
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import spock_tpu_torch
from spock_tpu_torch import build, mpc
from spock_tpu_torch.models import server_heat
from spock_tpu_torch.ops import _build, cuda_kernels, prox
from spock_tpu_torch.solver import Solver
from spock_tpu_torch.zv import DUAL_BLOCKS, Dual

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "spock_tpu_torch"


def test_import_and_solve_load_no_jax():
    code = (
        "import sys, numpy as np, torch\n"
        "import spock_tpu_torch as st\n"
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


def test_sources_import_no_jax():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|spock_tpu)(\.|\s|$)", re.M)
    files = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        assert not pattern.search(f.read_text()), f


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


@pytest.mark.parametrize("entry", ["build", "Solver", "simulate_async"])
def test_entry_points_default_to_the_card(no_cuda, cpu_problem, entry):
    """Without a device argument and without a card, every entry point
    raises instead of carrying on on the CPU."""
    data, meta = cpu_problem
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "build":
            build(server_heat.make_spec(N=3, nx=3, d=2))
        elif entry == "Solver":
            Solver(data, meta)
        else:
            mpc.simulate_async(data, meta, np.zeros((1, 3)),
                               np.zeros((1, 1), int), 1e-3, n_steps=1)


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


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library("prox_h_conj")


def test_kernel_support_follows_the_problem_class():
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
