"""table_gather_bwd_roofline: row 3, csrc/table_gather.cu (the adjoint gather), bound
by bytes: its work from shapes over its summed device time, against the
published peaks."""

from portbench.core import readers


def read(run):
    return readers.roofline(run, "table_gather_bwd")
