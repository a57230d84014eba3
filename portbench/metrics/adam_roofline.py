"""adam_roofline: the fused Adam kernel, csrc/fused_adam.cu, bound by bytes:
the least time a step's update needs (28 bytes a weight: p, g, m and v
read once, p, m and v written once, over every weight of the driver's
param_shapes, at 3.35 TB/s) over the summed device time of the kernel's
launches that start in the step. Steps count as in readers.roofline: only
those whose launches all have device time, and as many of them as most
steps have; the others are counted in run.notes. A program without the
kernel gives nothing to read."""

import collections
import math

from portbench.core import counts

KERNEL = "fused_adam_kernel"
BYTES_PER_WEIGHT = 7 * counts.F32


def read(run):
    shapes = getattr(run.driver, "param_shapes", None)
    if run.trace is None or not shapes:
        return None
    by_step = collections.defaultdict(list)
    for k in run.trace.kernels:
        if k.step >= 0 and KERNEL in k.name:
            by_step[k.step].append(k)
    if not by_step:
        return None
    expected = collections.Counter(len(v) for v in by_step.values()).most_common(1)[0][0]
    ns = counted = 0
    for ks in by_step.values():
        if len(ks) != expected or any(k.dur <= 0 for k in ks):
            continue
        ns, counted = ns + sum(k.dur for k in ks), counted + 1
    run.notes.append(f"adam_roofline: {counted} of {len(run.trace.steps)} steps counted, "
                     f"{expected} launch(es) a step; the others had a launch without device "
                     f"time, or missing")
    if not ns:
        return None
    weights = sum(math.prod(s) for s in shapes.values())
    return 100.0 * counts.bound_s(BYTES_PER_WEIGHT * weights * counted, 0)[0] / (ns * 1e-9)
