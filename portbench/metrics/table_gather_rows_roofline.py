"""table_gather_rows_roofline: row 6, csrc/table_gather.cu (the patch-only gather),
bound by bytes: its work from shapes over its summed device time, against
the published peaks."""

from portbench.core import readers


def read(run):
    return readers.roofline(run, "table_gather_rows")
