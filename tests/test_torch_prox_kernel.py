"""The prox_h* kernel (csrc/prox_h_conj.cu, TPU kernel #1): its class, its
plain path against the JAX package's Pallas kernel in interpret mode, and on
the card the kernel against its plain version, with every output pre-filled
with NaN so that an entry no thread writes shows.

JAX is imported by the interpret-mode test alone, so the card tests also
run on a machine without JAX:  python -m pytest
tests/test_torch_prox_kernel.py -m cuda --noconftest -o addopts=""
-p no:cacheprovider
"""

import dataclasses

import numpy as np
import pytest
import torch

from spock_tpu_torch import build
from spock_tpu_torch.models import server_heat
from spock_tpu_torch.ops import cuda_kernels, prox
from spock_tpu_torch.zv import DUAL_BLOCKS, Dual

torch.set_num_threads(1)

SIGMA = 0.37
# a primal cone whose dual has a segment of each kind: zero, nonneg,
# nonpos, reals (server_heat's ny = 5 rows)
ALL_KINDS = (("reals", 1), ("nonneg", 2), ("nonpos", 1), ("zero", 1))


def test_class_is_not_narrowed_by_width():
    """No width cap: nx = nu = 33 (past the node body's 32 rows) is in the
    class, as in the JAX kernel's."""
    _, meta = build(server_heat.make_spec(N=2, nx=33, d=2),
                    dtype=torch.float64, device="cpu")
    assert cuda_kernels.supported(meta)


@pytest.mark.parametrize("segments, ok", [(4, True), (8, True), (9, False)])
def test_class_takes_every_segment_kind_up_to_eight_segments(segments, ok):
    _, meta = build(server_heat.make_spec(N=2, nx=3, d=2),
                    dtype=torch.float64, device="cpu")
    kinds = ("zero", "nonneg", "nonpos", "reals")
    cone = tuple((kinds[k % 4], 1) for k in range(segments))
    meta = dataclasses.replace(meta, cone=cone)
    assert {k for k, _ in meta.dual_cone} == set(kinds)
    assert cuda_kernels.supported(meta) == ok


def test_plain_path_matches_the_pallas_kernel_on_an_odd_width():
    """cuda_kernels.prox_h_conj_fused on CPU tensors (its plain version)
    against the Pallas kernel in interpret mode on server_heat N=4 at
    nx = nu = 7, with every kind of cone segment; no launch is counted."""
    import jax.numpy as jnp

    from spock_tpu.models import server_heat as jsh
    from spock_tpu.ops import pallas_kernels
    from spock_tpu.problem import build as jbuild
    from tests.torch_parity import (
        assert_close, port_data, rand_pair, to_jax, to_port)

    jdata, jmeta = jbuild(jsh.make_spec(N=4, nx=7, d=2), dtype=jnp.float64)
    jmeta = dataclasses.replace(jmeta, cone=ALL_KINDS)
    pdata, pmeta = port_data(jdata, jmeta)
    assert cuda_kernels.supported(pmeta) and pallas_kernels.supported(jmeta)
    _, v = rand_pair(np.random.default_rng(7), jmeta, batch=(3,))
    # values past the boxes and the cone's bounds on both sides
    v = dataclasses.replace(v, **{k: 3.0 * getattr(v, k)
                                  for k in ("y", "cx", "cu", "cxN")})
    ref = pallas_kernels.prox_h_conj_fused(jdata, jmeta, to_jax(v), SIGMA,
                                           interpret=True)
    before = cuda_kernels.LAUNCHES
    got = cuda_kernels.prox_h_conj_fused(pdata, pmeta, to_port(v), SIGMA)
    assert cuda_kernels.LAUNCHES == before
    assert_close(got, ref, atol=1e-12, path="prox_h_conj_fused")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _nan_outputs(monkeypatch):
    """The wrapper's outputs allocated filled with NaN."""
    monkeypatch.setattr(torch, "empty_like",
                        lambda a: torch.full_like(a, float("nan")))


WIDTHS = {"headline": dict(N=10, nx=20), "nx7": dict(N=4, nx=7),
          "nx33": dict(N=4, nx=33)}


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_kernel_matches_plain_version(monkeypatch, width, dtype, B):
    """The wrapper's one launch against prox.prox_h_conj with every kind of
    cone segment: float64 within 1e-12, float32 within 1e-5 (1 + max|plain|)
    per block."""
    _card()
    data, meta = build(server_heat.make_spec(d=2, **WIDTHS[width]),
                       dtype=dtype)
    meta = dataclasses.replace(meta, cone=ALL_KINDS)
    rng = np.random.default_rng(0)
    shapes = cuda_kernels.block_shapes(meta, B)
    v = Dual(**{k: torch.tensor(3 * rng.standard_normal(shapes[k]),
                                dtype=dtype, device="cuda")
                for k in DUAL_BLOCKS})
    ref = prox.prox_h_conj(data, meta, v, SIGMA)
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    before = cuda_kernels.LAUNCHES
    with monkeypatch.context() as m:
        _nan_outputs(m)
        got = cuda_kernels.prox_h_conj_fused(data, meta, v, SIGMA)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES == before + 1
    for k in DUAL_BLOCKS:
        g, r = getattr(got, k), getattr(ref, k)
        assert bool(torch.isfinite(g).all()), k
        err = float((g - r).abs().max())
        assert err <= rtol * (1 + float(r.abs().max())), k


@pytest.mark.cuda
def test_unaligned_blocks_take_the_scalar_loads():
    """Blocks that start off a 16-byte boundary (views one value into a
    larger buffer) give the same values as aligned ones."""
    _card()
    data, meta = build(server_heat.make_spec(N=4, nx=7, d=2),
                       dtype=torch.float32)
    rng = np.random.default_rng(1)
    shapes = cuda_kernels.block_shapes(meta, 3)

    def shifted(shape):
        buf = torch.tensor(rng.standard_normal(int(np.prod(shape)) + 1),
                           dtype=torch.float32, device="cuda")
        return buf[1:].view(shape)

    v = Dual(**{k: shifted(shapes[k]) for k in DUAL_BLOCKS})
    aligned = Dual(**{k: getattr(v, k).clone() for k in DUAL_BLOCKS})
    got = cuda_kernels.prox_h_conj_fused(data, meta, v, SIGMA)
    ref = cuda_kernels.prox_h_conj_fused(data, meta, aligned, SIGMA)
    torch.cuda.synchronize()
    for k in DUAL_BLOCKS:
        assert torch.equal(getattr(got, k), getattr(ref, k)), k
