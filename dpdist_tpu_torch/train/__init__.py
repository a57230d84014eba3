from dpdist_tpu_torch.train.checkpoint import (
    load_checkpoint,
    load_dpdist_checkpoint,
    params_from_jax,
)

__all__ = ["load_checkpoint", "load_dpdist_checkpoint", "params_from_jax"]
