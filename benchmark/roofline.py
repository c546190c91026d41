"""The yardstick of the step kernels: the H100's published peaks and the
bytes and operations that a launch of ``sp_step_fused`` or
``sp_step_backtrack`` must move and compute, from the problem's shapes.

Frozen here from the port's kernel checks (``chip_smoke.py``,
``step_bytes_ops``, ``backtrack_bytes_ops``, ``sweep_ops``): each input read
once and each output written once; a lane reads the cache pair only when
its cache flag is set, and a looping lane's backtrack reads z, d and zbar
and writes z_new and s once.  Where the window cannot see a launch's cache
flags (inside a CUDA graph), the cache pair counts as unread and the fresh
sweep as not run: a lower bound of the work, so a share of the roofline
never reads above the truth.  The constants the kernels read (the build's
factors) are left out for the same reason.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores

# the output scalars of a lane, by both kernels (16 slots)
N_OC = 16
N_SC = 10
N_KEEP = 8


def tree_sizes(N: int, d: int) -> tuple:
    """(nodes, non-leaf nodes, leaves) of a uniform tree of N stages."""
    n = (d ** N - 1) // (d - 1)
    n_leaf = d ** (N - 1)
    return n, n - n_leaf, n_leaf


def pair_values(shape: dict) -> int:
    """Values of one lane's (z, v) pair: the primal (x, u, s, tau, y) and
    the dual (y, sby, qx, ru, t5, t6, cx, cu, qNx, s12, s13, cxN, and the
    polytope rows nc, ncN where the configuration has them)."""
    nx, nu, d = shape["nx"], shape["nx"], shape["d"]
    ny = shape.get("ny", 2 * d + 1)
    nc, nc_n = shape.get("nc", 0), shape.get("ncN", 0)
    n, n_nl, n_lf = tree_sizes(shape["N"], d)
    nz = nx * n + nu * n_nl + n + (n - 1) + ny * n_nl
    nv = (ny * n_nl + n_nl + (nx + nu + 2) * (n - 1) + (nx + nu) * n_nl
          + (nx + 2) * n_lf + nx * n_lf + nc * n_nl + nc_n * n_lf)
    return nz + nv


def sweep_ops(shape: dict, metric: bool, direction: bool) -> int:
    """Floating-point operations per lane of one sweep (a multiply-add
    counts 2): the matrix blocks of L and L', the Riccati sweeps, the S2
    projector, ~10 elementwise operations per value of the pair, and L, L'
    again for the metric and for the direction."""
    nx, nu, d = shape["nx"], shape["nx"], shape["d"]
    ny = shape.get("ny", 2 * d + 1)
    nc, nc_n = shape.get("nc", 0), shape.get("ncN", 0)
    n, n_nl, n_lf = tree_sizes(shape["N"], d)
    pair = pair_values(shape)
    l_ops = 2 * (n_nl * ny + (n - 1) * (nx * nx + nu * nu) + n_lf * nx * nx
                 + n_nl * nc * (nx + nu) + n_lf * nc_n * nx)
    ops = 2 * l_ops + 2 * pair
    mker = ny + 2 * d
    ops += 2 * n_nl * (2 * d * nx * nu + nu * nu + d * nx * nx + nu * nx)
    ops += 2 * n_nl * (nu * nx + d * nx * nx + d * nx * nu)
    ops += 2 * n_nl * mker * mker + 10 * pair
    ops += (2 * l_ops + 4 * pair) * (int(metric) + int(direction))
    return ops


def step_launch(shape: dict, lanes: int, cached: float = 0.0,
                itemsize: int = 4) -> tuple:
    """(bytes, operations) of one ``sp_step_fused`` launch over ``lanes``
    lanes, ``cached`` the share of lanes whose cache flag is set: eight
    pairs read (z and v, the cache where set, r_prev, s_prev, two MR and
    two MP rows), x0 and the scalar pack; six pairs and the output scalars
    written; the fresh sweep where no cache, the candidate sweep, and ~40
    operations per value of the pair."""
    pair = pair_values(shape) * itemsize
    nbytes = lanes * ((7 + cached) * pair + 6 * pair
                      + (shape["nx"] + N_SC + N_OC) * itemsize)
    per_lane = ((1.0 - cached) * sweep_ops(shape, True, False)
                + sweep_ops(shape, True, True) + 40 * pair_values(shape))
    return nbytes, lanes * per_lane


def backtrack_launches(shape: dict, lanes: int, launches: int,
                       looping: int, trials: int, itemsize: int = 4) -> tuple:
    """(bytes, operations) of ``launches`` ``sp_step_backtrack`` launches
    over ``lanes`` lanes in which ``looping`` lanes in all made ``trials``
    trials: z, d and zbar read and z_new and s written once at a looping
    lane, the input and output scalars of every lane read and written; the
    candidate sweep and ~20 operations per value a trial."""
    pair = pair_values(shape) * itemsize
    nbytes = 5 * looping * pair + launches * lanes * 2 * N_OC * itemsize
    ops = trials * (sweep_ops(shape, True, True) + 20 * pair_values(shape))
    return nbytes, ops


def bound_s(nbytes: float, ops: float) -> float:
    """Least seconds the card could take: the larger of the bytes over the
    memory rate and the operations over the float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)
