"""The JAX package's reference solves for the port's multi-process tests,
computed in a process of their own.

    python tests/jax_ref_worker.py MODE OUT_NPZ [ARG]

Each XLA:CPU executable holds memory mappings of its own, and a tier-1 test
worker that has run several JAX test files is close to the kernel's limit
(65,530 a process), so these solves stay out of the test worker, as
``tests/node_sharding_worker.py`` keeps the JAX package's own sharded
solves out of it.  :class:`Ref` starts the process (the test works
meanwhile) and reads its arrays.

Modes (float64, the JAX package's single-process ``Solver``):
  cp <d>   CP on server_heat N=6 nx=4 d, B=2 lanes from default_rng(3),
           600 iterations at tol 1e-6;
  sp       SuperMann on server_heat N=5 nx=4 d=3, B=2 from default_rng(4),
           tol 1e-4;
  lanes    SuperMann on server_heat N=3 nx=3 d=2, B=8 from default_rng(0),
           tol 1e-6 (``tests/multihost_worker.py``'s problem).

Modes of the examples' tests (``tests/test_torch_examples_solve.py``), the
JAX examples' problems and draws at the ports' small sizes:
  risk_small  the seven risk rows of ``examples/risk_sweep.py --small``
              (N=4 d=3 nx=6), cold SuperMann solves to tol 1e-5;
  mpc_small   ``mpc.simulate`` as ``examples/mpc_simulation.py`` draws it,
              at N=3 nx=3, 4 lanes, 3 steps, tol 1e-6;
  residuals_small  ``examples/residuals.py``'s traces at nx=3 N=4, tol
              1e-5: the whole CP trace and SuperMann's first row.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 240


class Ref:
    """One reference solve in a process of its own; :meth:`wait` returns
    its arrays (a failure or a run past TIMEOUT_S fails the caller)."""

    def __init__(self, mode: str, out_dir, *args):
        tag = "_".join([mode, *map(str, args)])
        self.out = Path(out_dir) / f"jax_{tag}.npz"
        env = {k: v for k, v in os.environ.items()
               if k not in ("PYTHONPATH", "XLA_FLAGS")}
        env.update(PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
                   OMP_NUM_THREADS="1")
        self.proc = subprocess.Popen(
            [sys.executable, __file__, mode, str(self.out), *map(str, args)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)

    def wait(self) -> dict:
        try:
            out = self.proc.communicate(timeout=TIMEOUT_S)[0].decode()
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        assert self.proc.returncode == 0, out[-3000:]
        return dict(np.load(self.out))


def risk_small():
    import dataclasses

    import jax.numpy as jnp

    from spock_tpu import build, risks
    from spock_tpu.models import server_heat
    from spock_tpu.solver import Solver

    N, d, nx = 4, 3, 6
    base = server_heat.make_spec(N=N, nx=nx, d=d)
    nnl = base.tree.n_nonleaf
    rng = np.random.default_rng(0)
    p = risks.rand_probvec(rng, d)
    x0 = rng.uniform(-0.5, 0.5, nx)
    sweep = [risks.risk_neutral(p, nnl)]
    sweep += [risks.avar(p, a, nnl) for a in (0.99, 0.9, 0.5, 0.1)]
    sweep += [risks.total_variation(p, 0.3, nnl), risks.evar(p, 0.5, nnl)]
    objective, converged = [], []
    for risk in sweep:
        data, meta = build(dataclasses.replace(base, risk=risk),
                           dtype=jnp.float64)
        res = Solver(data, meta, algorithm="spock",
                     max_iter=3000).solve(x0, tol=1e-5)
        objective.append(float(res.z.s[0]))
        converged.append(bool(res.converged))
    return dict(objective=np.array(objective), converged=np.array(converged))


def mpc_small():
    import jax.numpy as jnp

    from spock_tpu import build, mpc
    from spock_tpu.models import server_heat

    data, meta = build(server_heat.make_spec(N=3, nx=3, d=2),
                       dtype=jnp.float64)
    rng = np.random.default_rng(0)
    x0 = jnp.asarray(rng.uniform(-0.1, 0.1, (4, meta.nx)))
    ws = jnp.asarray(rng.integers(0, 2, (3, 4)))
    res = mpc.simulate(data, meta, x0, ws, tol=jnp.asarray(1e-6))
    return dict(xs=np.asarray(res.xs), us=np.asarray(res.us),
                status=np.asarray(res.status))


def residuals_small():
    import jax.numpy as jnp

    from spock_tpu import build
    from spock_tpu.algorithms import cp as cp_alg
    from spock_tpu.algorithms import supermann as sp_alg
    from spock_tpu.models import server_heat
    from spock_tpu.solver import zero_dual, zero_primal

    data, meta = build(server_heat.make_spec(N=4, nx=3, d=2),
                       dtype=jnp.float64)
    rng = np.random.default_rng(0)
    x0 = jnp.asarray(rng.uniform(-0.1, 0.1, (1, meta.nx)))
    z0 = zero_primal(meta, (1,), jnp.float64)
    v0 = zero_dual(meta, (1,), jnp.float64)
    tol = jnp.asarray(1e-5)
    cp = cp_alg.run_cp(data, meta, x0, z0, v0, tol=tol, max_iter=5000,
                       record=True)
    sp = sp_alg.run_supermann(data, meta, x0, z0, v0, tol=tol, max_iter=1,
                              record=True)
    n = int(cp.iterations[0])
    return dict(cp_iters=np.array(n),
                cp_trace=np.asarray(cp.residuals)[:n, 0, :],
                sp_first=np.asarray(sp.residuals)[0, 0, :])


EXAMPLES = dict(risk_small=risk_small, mpc_small=mpc_small,
                residuals_small=residuals_small)


def main():
    mode, out = sys.argv[1], sys.argv[2]
    args = sys.argv[3:]
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from spock_tpu import build
    from spock_tpu.models import server_heat
    from spock_tpu.solver import Solver

    if mode in EXAMPLES:
        np.savez(out, **EXAMPLES[mode]())
        return
    if mode == "cp":
        N, nx, d, B, seed, tol = 6, 4, int(args[0]), 2, 3, 1e-6
        kw = dict(algorithm="cp", max_iter=600)
    elif mode == "sp":
        N, nx, d, B, seed, tol = 5, 4, 3, 2, 4, 1e-4
        kw = dict(algorithm="spock")
    else:
        N, nx, d, B, seed, tol = 3, 3, 2, 8, 0, 1e-6
        kw = dict(algorithm="spock")
    data, meta = build(server_heat.make_spec(N=N, nx=nx, d=d),
                       dtype=jnp.float64)
    x0 = np.random.default_rng(seed).uniform(-0.5, 0.5, (B, nx))
    res = Solver(data, meta, **kw).solve(jnp.asarray(x0), tol=tol)
    np.savez(out, iterations=np.asarray(res.iterations),
             status=np.asarray(res.status), u=np.asarray(res.z.u),
             s0=np.asarray(res.z.s[:, 0]))


if __name__ == "__main__":
    main()
