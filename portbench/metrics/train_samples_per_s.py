"""train_samples_per_s: clouds trained per second, counting completed optimizer
steps over the whole window."""

from portbench.core import readers


def read(run):
    return readers.rate(run)
