"""table_gather_bwd_roofline.train: row 3, csrc/table_gather.cu (the adjoint
gather), in a training cell, bound by bytes: its work from shapes over its
summed device time, against the published peaks (table_gather_bwd_roofline
reads the same in the gradient cell)."""

from portbench.core import readers


def read(run):
    return readers.roofline(run, "table_gather_bwd")
