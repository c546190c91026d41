"""What a run of an example records beside its numbers: the device it ran
on (the card's name and power limit as ``nvidia-smi`` gives them, or
``"cpu"``), the torch and CUDA versions, the path flags of a problem, and
the launches of every kernel wrapper.

    device = runinfo.device(cpu=args.cpu)      # raises without a card
    runinfo.reset_launches()
    ...                                        # the run
    out = dict(**runinfo.environment(device), launches=runinfo.launches())
"""

from __future__ import annotations

import subprocess

import torch

from ..problem import resolve_device


def device(cpu: bool = False) -> torch.device:
    """The examples' device: the card, or the CPU when ``cpu``; without a
    card and without ``cpu`` this raises, as the entry points do."""
    return resolve_device("cpu" if cpu else None)


def card(dev=None) -> str:
    """``name, power limit`` of the card (``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader``, first line), or ``"cpu"``."""
    if dev is not None and torch.device(dev).type == "cpu":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def environment(dev) -> dict:
    """The device line and the versions a result was measured with."""
    dev = torch.device(dev)
    return dict(card=card(dev), device=str(dev), torch=torch.__version__,
                cuda=torch.version.cuda,
                device_name=(torch.cuda.get_device_name(dev)
                             if dev.type == "cuda" else "cpu"))


def path_flags(data, meta, opts=None) -> dict:
    """Which path a problem takes: the fused step (``use_fused_step``), the
    sweep kernels' class (``sweep_kernels.supported``), whether a node fits
    the node body (``node_fits``), the body the sweep kernels run and the
    body the step kernels run (``spstep.step_body``; None off the fused
    step)."""
    from ..algorithms import supermann as sp_alg
    from ..ops import spstep, sweep_kernels

    opts = opts or sp_alg.SuperMannOpts()
    sweep = sweep_kernels.supported(meta, data)
    fused = bool(sp_alg.use_fused_step(data, meta, opts))
    return dict(
        use_fused_step=fused,
        sweep_kernels_supported=bool(sweep),
        node_fits=bool(sweep_kernels.node_fits(meta)),
        sweep_body=(sweep_kernels.sweep_body(meta, data, data.dtype)
                    if sweep else None),
        step_body=spstep.step_body(meta, data, data.dtype) if fused else None)


def launches() -> dict:
    """{wrapper: launches} of every kernel wrapper, the sweep kernels' by
    body too, since the last :func:`reset_launches`."""
    from ..ops import cuda_kernels, spstep, sweep_kernels

    return dict(sweep_kernels.LAUNCHES, **spstep.LAUNCHES,
                prox_h_conj=cuda_kernels.LAUNCHES)


def reset_launches() -> None:
    """Every kernel wrapper's launch count set to 0."""
    from ..ops import cuda_kernels, spstep, sweep_kernels

    with cuda_kernels.COUNT_LOCK:
        cuda_kernels.LAUNCHES = 0
        for counts in (sweep_kernels.LAUNCHES, spstep.LAUNCHES):
            for k in counts:
                counts[k] = 0


def output_path(out_dir, name: str) -> str:
    """``out_dir/name``, made if missing; ``name`` must begin with
    ``torch_``, so that a run of the port never overwrites an artifact of
    the JAX package's examples beside it."""
    import os

    if not os.path.basename(name).startswith("torch_"):
        raise ValueError(f"{name!r}: the port's outputs are named torch_*")
    os.makedirs(out_dir, exist_ok=True)
    return os.path.join(out_dir, name)


def write_json(out_dir, name: str, payload: dict) -> str:
    import json

    path = output_path(out_dir, name)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    return path


def save_figure(fig, out_dir, name: str) -> str:
    """A matplotlib figure as a PNG in ``out_dir``."""
    import matplotlib.pyplot as plt

    path = output_path(out_dir, name)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path
