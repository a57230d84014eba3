"""host_ms.serve: mean host ms of one call into serving.FrozenDistance, up to
its return, before the read-back (the benchmark's own span)."""

from portbench.core import readers


def read(run):
    return readers.host_ms(run)
