"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place and computed one precision below the
configuration's, float32 with TF32 products (the configuration states
float32 with TF32 off).  TF32 is emulated: every operand of a product is
rounded to 10 mantissa bits, as the tensor cores round it; the card's own
TF32 switch reaches only its matrix-matrix products, and this problem is
made of matrix-vector ones.  It solves at states drawn as the cell draws
them, applies the plant, and is judged by the same numbers as the program;
a sound check reads it as not correct.  The benchmark's runs never run it.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

prints, for each seed, the control's numbers beside the cell's limits, on
the card when there is one.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def readings(config: dict, mix: dict, seed: int, states: int,
             device="cuda:0") -> dict:
    """The control's numbers at ``states`` states drawn as the cell draws
    them (U(-h, h) from the seed)."""
    sys.path.insert(0, str(ROOT))
    import importlib

    from benchmark.reference import checks, mpc

    model = importlib.import_module(
        f"benchmark.reference.{config['reference']}").make(config)
    P64 = mpc.Problem.of(model, torch.float64, device)
    P32 = mpc.Problem.of(model, torch.float32, device, tf32=True)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    h = mix["x0_half_width"]
    x = ((2 * torch.rand((states, model["nx"]), generator=g, device=device,
                         dtype=torch.float64) - 1) * h)
    w = torch.randint(0, model["d"], (states,), generator=g, device=device)
    sol = mpc.solve(P32, x.float(), mu_stop=1e-7, max_iter=100)
    u = sol.u0
    x_next = mpc.plant(P32, x.float(), u, w)
    ref = checks.reference(P64, x)
    # the control's tree trajectory in the program's layout [S, nx, n]
    zx = torch.cat(sol.xs, 1).transpose(1, 2)
    zu = torch.cat(sol.us, 1).transpose(1, 2)
    return dict(
        u_gap=checks.u_gap(ref, u.double()),
        obj_gap=checks.obj_gap(ref, sol.value.double()),
        plant_gap=checks.plant_gap(P64, x, u.double(), w, x_next.double()),
        dyn_gap=checks.dyn_gap(P64, zx, zu),
        converged=sol.converged)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--states", type=int, default=8)
    args = ap.parse_args(argv)
    device = "cuda:0" if torch.cuda.is_available() else "cpu"
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(c for c in bench["workloads"] if c["name"] == args.workload)
    bdir = ROOT / "benchmark"
    config = json.loads((bdir / "configs" / f"{cell['config']}.json")
                        .read_text())
    mix = json.loads((bdir / "mixes" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((bdir / "limits" / f"{cell['name']}.json")
                        .read_text())
    for seed in (int(s) for s in args.seeds.split(",")):
        r = readings(config, mix, seed, args.states, device)
        fails = [k for k, lim in limits.items() if k in r and r[k] > lim]
        print(json.dumps(dict(workload=args.workload, seed=seed, control=r,
                              limits=limits, fails=fails, device=device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
