"""step_idle_ms.train: device idle ms a training step while the innermost
span open on the host was the program's "train.step" itself (the step's
own glue between its forward, backward and optimizer: the leaves
gathered, the mean over the data axis, the gradient's norm), read from
the program's spans in a traced window."""

from portbench.core import program_spans


def read(run):
    return program_spans.idle_ms(run, lambda name: name == "train.step")
