"""Share of the step kernels' block cycles in their sweeps (fresh,
candidate, each retrial) in the traced window: the phase clock's five
sweep slots over block_total."""

from benchmark import inside


def read(run):
    return inside.phase_pct(inside.SWEEP_SLOTS)
