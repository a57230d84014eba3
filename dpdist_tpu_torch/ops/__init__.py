from dpdist_tpu_torch.ops.chamfer import chamfer_distance, nn_distance, pairwise_sqdist
from dpdist_tpu_torch.ops.emd import earth_mover_distance, sinkhorn_emd
from dpdist_tpu_torch.ops.threedmfv import threedmfv, threedmfv_grid, threedmfv_plain
from dpdist_tpu_torch.ops.voxel import (
    extract_patches,
    gather_patches,
    grid_centers,
    voxel_assign,
)

__all__ = ["chamfer_distance", "nn_distance", "pairwise_sqdist", "earth_mover_distance",
           "sinkhorn_emd", "threedmfv", "threedmfv_grid", "threedmfv_plain", "extract_patches",
           "gather_patches", "grid_centers", "voxel_assign"]
