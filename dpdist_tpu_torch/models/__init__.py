from dpdist_tpu_torch.models.dpdist import (
    apply_direction,
    apply_dpdist,
    dpdist_distance,
    init_dpdist,
    resolve_for_grad,
)

__all__ = ["apply_direction", "apply_dpdist", "dpdist_distance", "init_dpdist",
           "resolve_for_grad"]
