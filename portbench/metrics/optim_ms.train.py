"""optim_ms.train: host ms a training step inside the program's
"train.optimizer" span (train.optim.Optimizer.step: its launches over
every parameter leaf), read from the program's spans in a traced window."""

from portbench.core import program_spans


def read(run):
    return program_spans.host_ms(run, "train.optimizer")
