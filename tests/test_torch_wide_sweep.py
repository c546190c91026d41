"""The port's four whole-sweep functions on two-sided polytope rows and on
per-node costs against the JAX package's Pallas sweep kernels in interpret
mode, float64 on the CPU (the per-node-risk and combined problems are in
tests/test_torch_wide_ops.py)."""

import pytest
import torch

from tests.test_torch_wide_ops import (
    CALLS, fused_parity, kernel_problem_of, support_parity)
from tests.torch_parity import release_jax_executables  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["poly_n4", "pncost"])
def kernel_problem(request):
    return kernel_problem_of(request.param)


@pytest.mark.parametrize("name", list(CALLS))
def test_fused_function_matches_jax_kernel(kernel_problem, name):
    fused_parity(kernel_problem, name)


def test_support_matches_jax_in_both_directions(kernel_problem):
    support_parity(kernel_problem)
