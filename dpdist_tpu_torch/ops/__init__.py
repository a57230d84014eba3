from dpdist_tpu_torch.ops.chamfer import chamfer_distance, nn_distance, pairwise_sqdist
from dpdist_tpu_torch.ops.emd import earth_mover_distance, sinkhorn_emd, sinkhorn_emd_blocked
from dpdist_tpu_torch.ops.knn import knn, pairwise_distance
from dpdist_tpu_torch.ops.threedmfv import threedmfv, threedmfv_grid, threedmfv_plain
from dpdist_tpu_torch.ops.voxel import (
    extract_patches,
    gather_patches,
    grid_centers,
    neighbor_ids,
    voxel_assign,
)

__all__ = ["chamfer_distance", "nn_distance", "pairwise_sqdist", "earth_mover_distance",
           "sinkhorn_emd", "sinkhorn_emd_blocked", "knn", "pairwise_distance", "threedmfv", "threedmfv_grid", "threedmfv_plain", "extract_patches",
           "gather_patches", "grid_centers", "neighbor_ids", "voxel_assign"]
