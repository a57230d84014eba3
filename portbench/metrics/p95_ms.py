"""p95_ms: the 95th percentile, over every call in the window, of one call from
the call to its answer on the host."""

from portbench.core import readers


def read(run):
    return readers.p95_ms(run)
