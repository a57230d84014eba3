"""Faults planted in the program under test, to show that a run's check
catches each fault that a cell can have.

    with planted("serve", "altered"):
        result, notes = core.cell.run(...)        # result["correct"] is False

  altered     an answer altered where it is produced: one distance of each
              call, or the loss of each call or step, off by ALTER;
  half_batch  half of the batch left out, the rest answered or averaged
              over the first half;
  unchanged   a training step that returns its state unchanged: the
              optimizer counts the step and moves no parameter.

The exchange between chips, a fourth kind of fault, has no
place in a one-chip cell. calibrate.py --fault reads each fault at a
cell's own size; portbench/tests run them at a small one on the CPU.
"""

from __future__ import annotations

import contextlib

ALTER = 1e-3            # absolute on a distance or a frozen loss; relative on an AUE loss

FAULTS = {
    "serve": ("altered", "half_batch"),
    "grad": ("altered", "half_batch"),
    "aue_train": ("altered", "half_batch", "unchanged"),
}


@contextlib.contextmanager
def _patched(owner, name, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def _half(x):
    return x[:x.shape[0] // 2]


def _serve(fault):
    from dpdist_tpu_torch.serving import FrozenDistance

    def make(orig):
        def forward(self, a, b):
            if fault == "half_batch":
                d = orig(self, _half(a), _half(b))
                return d.repeat(2)
            d = orig(self, a, b).clone()
            d[0] += ALTER
            return d
        return forward

    return _patched(FrozenDistance, "forward", make)


def _grad(fault):
    from dpdist_tpu_torch.losses import dpdist_loss

    def make(orig):
        def make_loss(*args, **kwargs):
            fn = orig(*args, **kwargs)
            if fault == "half_batch":
                return lambda a, b: fn(_half(a), _half(b))
            return lambda a, b: fn(a, b) + ALTER
        return make_loss

    return _patched(dpdist_loss, "make_frozen_dpdist_loss", make)


def _aue_train(fault):
    from dpdist_tpu_torch.train.aue_trainer import AUETrainer
    from dpdist_tpu_torch.train.optim import Optimizer

    if fault == "unchanged":
        def make(orig):
            def step(self, params, grads, state):
                return {**state, "count": state["count"] + 1}
            return step
        return _patched(Optimizer, "step", make)

    def make(orig):
        def step_loss(self, params, state, batch):
            if fault == "half_batch":
                return orig(self, params, state, tuple(_half(x) for x in batch))
            loss, new_state = orig(self, params, state, batch)
            return loss * (1 + ALTER), new_state
        return step_loss

    return _patched(AUETrainer, "step_loss", make)


def planted(driver: str, fault: str):
    """A context in which the program carries `fault` for cells of `driver`."""
    if fault not in FAULTS[driver]:
        raise ValueError(f"{driver} cells have the faults {FAULTS[driver]}, not {fault!r}")
    return {"serve": _serve, "grad": _grad, "aue_train": _aue_train}[driver](fault)
