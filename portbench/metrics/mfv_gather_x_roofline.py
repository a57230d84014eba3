"""mfv_gather_x_roofline: row 1, csrc/mfv_gather.cu (the fused encode and
gather), bound by bytes: its work from shapes over its summed device time,
against the published peaks."""

from portbench.core import readers


def read(run):
    return readers.roofline(run, "mfv_gather_x")
