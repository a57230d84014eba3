from dpdist_tpu_torch.train.checkpoint import (
    archive_checkpoint,
    archived_metric,
    latest_checkpoint,
    load_checkpoint,
    load_dpdist_checkpoint,
    params_from_jax,
    params_to_numpy,
    restore_checkpoint,
    restore_params_maybe_state,
    save_checkpoint,
)

__all__ = ["archive_checkpoint", "archived_metric", "latest_checkpoint", "load_checkpoint",
           "load_dpdist_checkpoint", "params_from_jax", "params_to_numpy", "restore_checkpoint",
           "restore_params_maybe_state", "save_checkpoint"]
