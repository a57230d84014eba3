"""threedmfv_roofline: row 7, csrc/threedmfv.cu (the streaming encode), bound
by operations: its work from shapes over its summed device time, against the
published peaks."""

from portbench.core import readers


def read(run):
    return readers.roofline(run, "threedmfv")
