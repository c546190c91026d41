"""What the per-layer metrics read from inside the program: the host spans
that ``spock_tpu_torch.utils.profiling`` records while a profiler records
(the traced window), and the phase cycles that the step kernels add to
their device counter meanwhile (``ops.spstep.phase_cycles``).  Each gives
None where the program has neither, or they hold nothing: the readers then
leave their metric out."""

from __future__ import annotations

# the parts of a sweep among spstep.PHASES
SWEEP_SLOTS = ("lprime_s2", "riccati_backward", "riccati_forward",
               "prox_hconj", "metric")


def spans():
    """{name: (count, total seconds, self seconds)} of the program's spans,
    None without any."""
    from spock_tpu_torch.utils import profiling

    table = getattr(profiling, "spans", lambda: {})()
    if not table:
        return None
    return {k: (n, tot * 1e-9, own * 1e-9) for k, (n, tot, own) in
            table.items()}


def span_ms(parts, per: str):
    """Milliseconds of ``parts`` ((name, "total" | "self") pairs) summed,
    over the count of the span ``per``; None where ``per`` never closed."""
    table = spans()
    if not table or not table.get(per, (0,))[0]:
        return None
    secs = sum(table[name][2 if kind == "self" else 1]
               for name, kind in parts if name in table)
    return 1e3 * secs / table[per][0]


def phase_pct(slots):
    """100 x the step kernels' cycles in ``slots`` over their blocks'
    cycles (``block_total``); None without cycles."""
    from spock_tpu_torch.ops import spstep

    cycles = getattr(spstep, "phase_cycles", lambda: None)()
    if not cycles or not cycles.get("block_total"):
        return None
    return 100.0 * sum(cycles[s] for s in slots) / cycles["block_total"]
