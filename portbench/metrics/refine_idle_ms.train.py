"""refine_idle_ms.train: device idle ms a training step inside the program's
"pcrnet.refine" span (the PCRNet refinement loop, its encoder's and head's
spans included), read from the program's spans in a traced window. The
frozen loss's own idle is forward_idle_ms.train less this. None for a
program that records no such span."""

from portbench.core import program_spans


def read(run):
    program = program_spans.records(run)
    if not program or not any(r[0] == "pcrnet.refine" for r in program):
        return None
    return program_spans.idle_ms_within(run, {"pcrnet.refine"})
