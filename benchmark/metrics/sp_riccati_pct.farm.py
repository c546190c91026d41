"""Share of the step kernels' block cycles in the S1 Riccati sweeps
(backward and forward) of every sweep they ran in the traced window: the
phase clock's slots riccati_backward + riccati_forward over block_total."""

from benchmark import inside


def read(run):
    return inside.phase_pct(("riccati_backward", "riccati_forward"))
