from dpdist_tpu_torch.ops.threedmfv import threedmfv, threedmfv_grid
from dpdist_tpu_torch.ops.voxel import (
    extract_patches,
    gather_patches,
    grid_centers,
    voxel_assign,
)

__all__ = ["threedmfv", "threedmfv_grid", "extract_patches", "gather_patches",
           "grid_centers", "voxel_assign"]
