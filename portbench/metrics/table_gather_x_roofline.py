"""table_gather_x_roofline: row 2, csrc/table_gather.cu (the table gather), bound by
bytes: its work from shapes over its summed device time, against the
published peaks."""

from portbench.core import readers


def read(run):
    return readers.roofline(run, "table_gather_x")
