from dpdist_tpu_torch.native.lib import (
    available,
    fast_loadtxt,
    min_distances_native,
    nn_distance_native,
)

__all__ = ["available", "fast_loadtxt", "min_distances_native", "nn_distance_native"]
