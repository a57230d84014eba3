"""model_idle_ms.grad: device idle ms a call while the innermost span open
on the host was the frozen loss's ("loss") or one of the model's
("dpdist.*"): the forward of the loss and its source gradient's call, read
from the program's spans in a traced window."""

from portbench.core import program_spans


def read(run):
    return program_spans.idle_ms(run, lambda name: name == "loss" or program_spans.is_model(name))
