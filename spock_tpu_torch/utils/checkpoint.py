"""Checkpoint and resume of solver state.

Solver state is explicit (warm starts are (z, v) passed in), so a
checkpoint is the (Primal, Dual) pair and any extras saved to one ``.npz``.
The keys are the JAX package's (``z.<field>``, ``v.<field>``,
``extra.<name>``), so a warm start saved by either package loads in the
other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..problem import resolve_device
from ..zv import Dual, Primal


def _numpy(val):
    if torch.is_tensor(val):
        return val.detach().cpu().numpy()
    return np.asarray(val)


def save_state(path: str, z: Primal, v: Dual, **extra):
    """Save solver state (and extras such as x0 or a step index) to .npz."""
    payload = {}
    for prefix, tree in (("z", z), ("v", v)):
        for f in dataclasses.fields(type(tree)):
            val = getattr(tree, f.name)
            if val is not None:
                payload[f"{prefix}.{f.name}"] = _numpy(val)
    for k, val in extra.items():
        payload[f"extra.{k}"] = _numpy(val)
    np.savez(path, **payload)


def load_state(path: str, device=None):
    """Returns (z, v, extras dict): z and v with tensor leaves on ``device``
    (default: the card) in the saved dtype, the extras as numpy arrays."""
    device = resolve_device(device)
    zkw = {f.name: None for f in dataclasses.fields(Primal)}
    vkw = {f.name: None for f in dataclasses.fields(Dual)}
    extras = {}
    with np.load(path) as data:
        for k in data.files:
            prefix, _, name = k.partition(".")
            if prefix == "z":
                zkw[name] = torch.as_tensor(data[k], device=device)
            elif prefix == "v":
                vkw[name] = torch.as_tensor(data[k], device=device)
            else:
                extras[name] = data[k]
    return Primal(**zkw), Dual(**vkw), extras
