"""One run of one cell of the benchmark of dpdist_tpu_torch on an NVIDIA card.

    python3 portbench/run.py --workload dpdist_serve_np64 --seed 7 --seconds 10 --trace 0

Sets the cell up from its seed (weights, traffic, warm-up: `setup_s`),
drives the program for `--seconds` (the end-to-end metrics with
--trace 0, the per-layer metrics from a torch.profiler trace of the same
window with --trace 1), then checks what the window produced against the
configuration's plain reference. Prints the numbers compared, each beside
its limit, as the last lines of standard error, and one JSON object as the
last line of standard output. Exits non-zero, and prints no result,
without a CUDA card (or fewer cards than the cell asks for), and where
JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    import torch

    from portbench.core.cell import emit, load_cell, run

    cell = load_cell(ROOT, a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{a.workload} needs {cell['chips']} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, notes = run(ROOT, cell, a.seed, a.seconds, bool(a.trace), torch.device("cuda", 0), T0)
    return emit(result, notes)


if __name__ == "__main__":
    sys.exit(main())
