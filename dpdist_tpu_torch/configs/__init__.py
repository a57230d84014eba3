from dpdist_tpu_torch.configs.config import (
    AUEConfig,
    DPDistConfig,
    MeshConfig,
    PCRNetConfig,
    TrainConfig,
)

__all__ = ["AUEConfig", "DPDistConfig", "MeshConfig", "PCRNetConfig", "TrainConfig"]
