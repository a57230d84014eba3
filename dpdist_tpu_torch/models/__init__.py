from dpdist_tpu_torch.models.dpdist import apply_dpdist, dpdist_distance

__all__ = ["apply_dpdist", "dpdist_distance"]
