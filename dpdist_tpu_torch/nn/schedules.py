"""Learning-rate and batch-norm schedules (port of
dpdist_tpu/nn/schedules.py; the reference's get_learning_rate and
get_bn_decay).

Both are evaluated in float32, as the reference evaluates them, and
return Python floats.
"""

from __future__ import annotations

import numpy as np


def staircase_lr(base_lr: float, decay_step: int, decay_rate: float, floor: float = 1e-7):
    """lr(step) = max(base_lr * decay_rate ** floor(step / decay_step), floor)."""
    f32 = np.float32

    def schedule(step) -> float:
        p = np.floor(f32(step) / f32(decay_step))
        lr = f32(base_lr) * np.power(f32(decay_rate), p, dtype=f32)
        return float(np.maximum(lr, f32(floor)))

    return schedule


def bn_momentum_schedule(init_decay: float = 0.5, decay_step: float = 300 * 512,
                         decay_rate: float = 0.5, clip: float = 0.99):
    """BN EMA momentum: min(clip, 1 - init_decay * decay_rate ** floor(step / decay_step))."""
    f32 = np.float32

    def schedule(step) -> float:
        p = np.floor(f32(step) / f32(decay_step))
        m = f32(init_decay) * np.power(f32(decay_rate), p, dtype=f32)
        return float(np.minimum(f32(clip), f32(1.0) - m))

    return schedule
