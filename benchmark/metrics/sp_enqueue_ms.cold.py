"""Host milliseconds a SuperMann iteration takes to enqueue its launches
and carry operations: the program's span spock.sp.iter, its total over its
count in the traced window."""

from benchmark import inside


def read(run):
    return inside.span_ms([("spock.sp.iter", "total")], "spock.sp.iter")
