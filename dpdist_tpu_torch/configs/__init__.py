from dpdist_tpu_torch.configs.config import DPDistConfig, TrainConfig

__all__ = ["DPDistConfig", "TrainConfig"]
