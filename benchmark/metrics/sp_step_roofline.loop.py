"""The step kernels (sp_step_fused, sp_step_backtrack) against their
roofline over the traced window: frozen bytes and operations of their
launches at the H100's peaks, over the time the profiler saw them take."""

from benchmark import readers


def read(run):
    return readers.step_roofline_pct(run)
