from dpdist_tpu_torch.data.synthetic import SHAPE_FAMILIES, synthetic_surface

__all__ = ["SHAPE_FAMILIES", "synthetic_surface"]
