from dpdist_tpu_torch.models.aue import apply_aue, init_aue
from dpdist_tpu_torch.models.dpdist import (
    apply_direction,
    apply_dpdist,
    dpdist_distance,
    dpdist_embed,
    forward_dpdist,
    init_dpdist,
    resolve_for_grad,
)
from dpdist_tpu_torch.models.pcrnet import (
    apply_pcrnet,
    init_pcrnet,
    init_pcrnet_state,
    pcrnet_refine,
)

__all__ = ["apply_aue", "init_aue", "apply_direction", "apply_dpdist", "dpdist_distance",
           "dpdist_embed", "forward_dpdist", "init_dpdist", "resolve_for_grad", "apply_pcrnet", "init_pcrnet",
           "init_pcrnet_state", "pcrnet_refine"]
