"""replays.train: the program's "threedmfv.replay" spans a training step,
the replays of the plain 3DmFV encode inside row 7's backward, read from
the program's spans in a traced window. The backward runs on autograd's
own thread on a card, so the spans of every thread count, by their start
in the window. None for a program that records no such span."""

from portbench.core import program_spans


def read(run):
    program = program_spans.records(run)
    if not program or not run.trace.steps:
        return None
    lo, hi = run.trace.window
    names = [n for n, _, s, e, _, _ in program if e > 0 and lo <= s < hi]
    if "threedmfv.replay" not in names:
        return None
    return names.count("threedmfv.replay") / len(run.trace.steps)
