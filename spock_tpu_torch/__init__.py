"""spock_tpu_torch — the SPOCK risk-averse MPC engine in PyTorch, for an
NVIDIA H100.

The port of the JAX package ``spock_tpu``: scenario trees with uniform
branching, linear tree-indexed dynamics, quadratic costs, conic risk
measures, box constraints, solved by Chambolle-Pock optionally accelerated
by SuperMann with Anderson or Broyden directions.  Plain tensor code is
PyTorch; each CP sweep is one CUDA kernel written for Hopper, and so is the
metric M and the prox_h* phase of the composed sweep (``csrc/``).

Entry points (``build``, ``Solver``, ``mpc.simulate_async``) run on the card
unless given ``device="cpu"``; without a card and without a device they
raise.
"""

import torch as _torch

# Matmul precision is a correctness rule: a reduced-precision float32 matmul
# (TF32 keeps ~10 mantissa bits) floors the solver's fixed-point residual and
# stalls warm-started lanes.  Pin true float32, as the JAX package pins
# "highest".
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from . import mpc, problem, risks, solver, zv  # noqa: E402,F401
from .algorithms.common import SolveResult  # noqa: E402,F401
from .algorithms.supermann import SuperMannOpts  # noqa: E402,F401
from .problem import Box, Cost, Dynamics, Polytope, Spec, build  # noqa: E402,F401
from .solver import Solver  # noqa: E402,F401
from .tree import UniformTree  # noqa: E402,F401

__version__ = "0.1.0"
