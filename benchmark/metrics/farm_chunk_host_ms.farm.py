"""Host milliseconds a farm chunk takes outside its wait: the self time of
the program's span spock.farm.chunk with its children spock.farm.copy_in
and spock.farm.replay (not spock.farm.check, the read that waits for the
card), over the chunks of the traced window."""

from benchmark import inside


def read(run):
    return inside.span_ms([("spock.farm.chunk", "self"),
                           ("spock.farm.copy_in", "total"),
                           ("spock.farm.replay", "total")],
                          "spock.farm.chunk")
