"""backward_idle_ms.grad: device idle ms a call while the benchmark's
"entry" span was open with no span of the program inside it: the caller's
autograd backward of the frozen loss (torch.autograd.grad), read from the
program's spans in a traced window."""

from portbench.core import program_spans


def read(run):
    return program_spans.idle_ms(run, lambda name: name == "entry")
