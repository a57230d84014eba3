from dpdist_tpu_torch.data.batching import assemble_dpdist_batch
from dpdist_tpu_torch.data.prefetch import PrefetchingLoader
from dpdist_tpu_torch.data.synthetic import SHAPE_FAMILIES, synthetic_surface

__all__ = ["assemble_dpdist_batch", "PrefetchingLoader", "SHAPE_FAMILIES", "synthetic_surface"]
