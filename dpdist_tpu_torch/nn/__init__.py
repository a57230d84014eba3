from dpdist_tpu_torch.nn.layers import (
    avg_pool2d,
    avg_pool3d,
    batchnorm_apply,
    batchnorm_init,
    conv2d_apply,
    conv2d_init,
    conv2d_transpose_apply,
    conv3d_apply,
    conv3d_init,
    dense_apply,
    dense_init,
    dropout,
    max_pool2d,
    max_pool3d,
    mlp_apply,
    mlp_apply_bn,
    mlp_bn_state,
    mlp_init,
    truncated_normal,
    xavier_uniform,
)
from dpdist_tpu_torch.nn.schedules import bn_momentum_schedule, staircase_lr

__all__ = ["avg_pool2d", "avg_pool3d", "batchnorm_apply", "batchnorm_init", "conv2d_apply",
           "conv2d_init", "conv2d_transpose_apply", "conv3d_apply", "conv3d_init",
           "dense_apply", "dense_init", "dropout", "max_pool2d", "max_pool3d", "mlp_apply",
           "mlp_apply_bn", "mlp_bn_state", "mlp_init", "truncated_normal", "xavier_uniform",
           "bn_momentum_schedule", "staircase_lr"]
