"""threedmfv_roofline.train: row 7, csrc/threedmfv.cu (the streaming encode),
in a training cell, bound by operations: its work from shapes over its
summed device time, against the published peaks (threedmfv_roofline reads
the same in the serving cell)."""

from portbench.core import readers


def read(run):
    return readers.roofline(run, "threedmfv")
