"""What a driver is: the loop body that drives one entry point of the
program, found by the name a traffic file gives (drivers/<name>.py,
class Driver).

The harness calls, in order:
  setup()         build the program's objects and the traffic from the
                  seed, and warm up every shape the window will use; all
                  of it counts as set-up;
  step(i)         one unit of work inside the window (a call, a training
                  step), with `ctx.spans` around the calls into the
                  program;
  drain()         wait until every step's work is done;
  release()       free the program's state, once the window has closed
                  and the memory peak has been read;
  check()         compare what the timed path produced with the plain
                  reference (float32, TF32 off); returns {number: reading}.
`control()` returns the same numbers with the reference computed in TF32
put in the program's place (the control, which has to fail; run by
calibrate.py, never by a benchmark run).
`units_per_step` counts what an end-to-end rate counts (pairs, samples),
`step_flops` a step's model FLOPs, and `kernel_work(kernel, step)` the
(bytes, flops) of one kernel's launches in step `step` (None where the
kernel takes no part).
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path

import torch

from portbench.core.trace import Spans


@dataclasses.dataclass
class Context:
    root: Path               # the checkout's root
    device: torch.device
    config_name: str
    seed: int
    config: dict             # configs/<config>.json
    traffic: dict            # traffic/<traffic>.json
    spans: Spans

    def config_named(self, name: str) -> dict:
        with open(self.root / "portbench" / "configs" / f"{name}.json") as f:
            return json.load(f)

    def reference(self, name=None):
        """The plain reference module of a configuration (this cell's by default)."""
        return importlib.import_module(f"portbench.reference.{name or self.config_name}")

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class Driver:
    units_per_step = 1

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.failed = 0          # steps whose answer is not finite

    def setup(self):
        raise NotImplementedError

    def step(self, i: int):
        raise NotImplementedError

    def drain(self):
        self.ctx.sync()

    def release(self):
        pass

    def step_flops(self) -> float:
        raise NotImplementedError

    def kernel_work(self, kernel: str, step: int):
        return None

    def check(self) -> dict:
        raise NotImplementedError

    def control(self) -> dict:
        raise NotImplementedError
