"""pairs_per_s: pairs scored by the frozen distance per second, all the
window's calls over all its time."""

from portbench.core import readers


def read(run):
    return readers.rate(run)
