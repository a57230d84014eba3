"""idle_pct.grad: 1 - the union of the device's kernel, copy and fill intervals
over the traced window."""

from portbench.core import readers


def read(run):
    return readers.idle_pct(run)
