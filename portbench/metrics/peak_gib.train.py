"""peak_gib.train: torch.cuda.max_memory_allocated over the window."""

from portbench.core import readers


def read(run):
    return readers.peak_gib(run)
