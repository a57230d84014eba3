"""grad_pairs_per_s: pairs whose frozen-loss value and source gradient were
completed per second, over the whole window."""

from portbench.core import readers


def read(run):
    return readers.rate(run)
