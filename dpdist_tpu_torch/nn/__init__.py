from dpdist_tpu_torch.nn.layers import dense_apply, mlp_apply

__all__ = ["dense_apply", "mlp_apply"]
