from dpdist_tpu_torch.losses.dpdist_loss import make_frozen_dpdist_loss
from dpdist_tpu_torch.losses.standard import (
    chamfer_loss,
    emd_loss,
    l1_sample_loss,
    pred_mean_loss,
)

__all__ = ["make_frozen_dpdist_loss", "chamfer_loss", "emd_loss", "l1_sample_loss",
           "pred_mean_loss"]
