"""mfu.serve: model FLOPs from shapes times the completed steps, over the
window, as a share of the H100's float32 peak of 67 TFLOP/s."""

from portbench.core import readers


def read(run):
    return readers.mfu(run)
