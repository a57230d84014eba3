from dpdist_tpu_torch.configs.config import DPDistConfig

__all__ = ["DPDistConfig"]
