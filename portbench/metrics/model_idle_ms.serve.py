"""model_idle_ms.serve: device idle ms a call while the innermost span open
on the host was one of the model's ("dpdist.encode", "dpdist.gather",
"dpdist.decode": the route, the voxel assignment, the kernels' and
layers' launches), read from the program's spans in a traced window."""

from portbench.core import program_spans


def read(run):
    return program_spans.idle_ms(run, program_spans.is_model)
