from dpdist_tpu_torch.configs.config import AUEConfig, DPDistConfig, PCRNetConfig, TrainConfig

__all__ = ["AUEConfig", "DPDistConfig", "PCRNetConfig", "TrainConfig"]
