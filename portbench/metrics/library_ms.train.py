"""library_ms.train: device ms per step in cuBLAS and cuDNN kernels, told apart
by name."""

from portbench.core import readers


def read(run):
    return readers.library_ms(run)
