"""forward_idle_ms.train: device idle ms a training step inside the
program's "train.forward" span (the loss function of the step, the model's
spans inside it included), read from the program's spans in a traced
window."""

from portbench.core import program_spans


def read(run):
    return program_spans.idle_ms_within(run, {"train.forward"})
