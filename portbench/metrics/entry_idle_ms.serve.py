"""entry_idle_ms.serve: device idle ms a call while the innermost span open
on the host was the program's "serve" (serving.FrozenDistance.forward's
own glue: the params and state trees rebuilt, the config resolved), read
from the program's spans in a traced window."""

from portbench.core import program_spans


def read(run):
    return program_spans.idle_ms(run, lambda name: name == "serve")
