"""The readings that a cell's correctness limits are set from.

    python3 portbench/calibrate.py --workload dpdist_serve_np64 \
        --seeds 1,2,3,...,12 --control-seeds 101,102,103 --seconds 2

For each seed of --seeds, one process-local run of the program at the
cell's own sizes and load (set-up, a window of --seconds, the check
against the float32 reference): the lower readings. For each seed of
--control-seeds, the control: the reference computed in TF32 put in the
program's place, judged by the same numbers: the upper readings. With
--fault, the runs of --seeds carry that fault of portbench/faults.py.
Prints one JSON line per run; the benchmark's own runs never run the
control or a fault. Needs a CUDA card, as a benchmark run does.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(root, cell, seed, seconds, device, control):
    """{"readings", "steps", "setup_s"} of one program run, or of the control."""
    from portbench.core.cell import make_driver, measure_window

    t0 = time.perf_counter()
    driver = make_driver(root, cell, seed, device)
    driver.setup()
    driver.ctx.sync()
    setup_s = time.perf_counter() - t0
    steps = 0
    if not control:
        steps, _ = measure_window(driver, driver.ctx.spans, seconds)
    driver.release()
    out = driver.control() if control else driver.check()
    return {"readings": out, "steps": steps, "failed": driver.failed, "setup_s": setup_s}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--fault", default=None, help="a fault of portbench/faults.py")
    a = p.parse_args(argv)

    import torch

    from portbench.core.cell import load_cell

    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA card", file=sys.stderr)
        return 2
    from portbench.faults import planted

    cell = load_cell(ROOT, a.workload)
    program = a.fault or "program"
    for kind, seeds in ((program, a.seeds), ("control", a.control_seeds)):
        for seed in (int(s) for s in seeds.split(",") if s):
            with (planted(cell["traffic"]["driver"], a.fault) if kind == a.fault
                  else contextlib.nullcontext()):
                rec = readings(ROOT, cell, seed, a.seconds, "cuda", kind == "control")
            print(json.dumps({"workload": a.workload, "kind": kind, "seed": seed, **rec}),
                  flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
