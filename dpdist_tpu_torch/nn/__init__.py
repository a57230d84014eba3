from dpdist_tpu_torch.nn.layers import (
    dense_apply,
    dense_init,
    dropout,
    mlp_apply,
    mlp_init,
    xavier_uniform,
)
from dpdist_tpu_torch.nn.schedules import bn_momentum_schedule, staircase_lr

__all__ = ["dense_apply", "dense_init", "dropout", "mlp_apply", "mlp_init", "xavier_uniform",
           "bn_momentum_schedule", "staircase_lr"]
