from dpdist_tpu_torch.configs.config import DPDistConfig, PCRNetConfig, TrainConfig

__all__ = ["DPDistConfig", "PCRNetConfig", "TrainConfig"]
