"""plain_encodes.grad: the model's "dpdist.encode" spans a call whose
detail is "plain", the encodes the route leaves to the plain 3DmFV
composition (below the streaming kernel's 128 points), from the program's
spans in a traced window."""

from portbench.core import program_spans


def read(run):
    return program_spans.count(run, "dpdist.encode", "plain")
