from dpdist_tpu_torch.eval import viz
from dpdist_tpu_torch.eval.comparison import monotonicity, perturbation_sweep
from dpdist_tpu_torch.eval.dense import dense_point_to_surface, distance_field
from dpdist_tpu_torch.eval.registration import accuracy_buckets, evaluate_registration

__all__ = [
    "evaluate_registration",
    "accuracy_buckets",
    "dense_point_to_surface",
    "distance_field",
    "perturbation_sweep",
    "monotonicity",
    "viz",
]
