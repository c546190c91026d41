"""Host milliseconds a farm call takes outside its chunks: the self time
of the program's span spock.farm.call (state set-up, bodies; not its
chunks, its first check or the final clone), over the calls of the traced
window."""

from benchmark import inside


def read(run):
    return inside.span_ms([("spock.farm.call", "self")], "spock.farm.call")
