"""launches.train: kernel launch calls per step in the profiler trace (an exact
count of the runtime and driver API's launch records)."""

from portbench.core import readers


def read(run):
    return readers.launches(run)
