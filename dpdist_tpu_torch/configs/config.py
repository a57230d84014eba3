"""DPDist model configuration (port of dpdist_tpu/configs/config.py).

Same field names, defaults and JSON form as the reference dataclass, so
the `model_config` string stored in a checkpoint's metadata parses into
either package.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class DPDistConfig:
    """DPDist model hyperparameters (canonical trained config by default)."""

    num_point: int = 64           # query points per cloud
    dims: int = 3                 # point dimensionality
    embedding_size: int = 512     # number of Gaussians / voxels (8**3)
    sigma: float = 0.125          # 3DmFV Gaussian stddev
    full_fv: bool = True          # 20 channels/Gaussian (mean+max+min pools)
    k: int = 5                    # local patch window; 0 = global embedding
    mlp: Tuple[int, ...] = (1024, 1024, 1024)  # implicit decoder widths
    conv_version: int = 1         # 1 = dense MLP, 3 = conv3d+resnet path
    encoder: str = "3dmfv"        # "3dmfv" | "pointnet"
    pointnet_embedding: int = 1024
    output_act: str = "relu"      # "relu" -> relu6(x)/3 in [0,2]; "tanh"; other -> relu6(x+3)/3-1
    use_bn: bool = False
    output_channels: int = 3      # decoder output channels; the distance reads channel 0
    dtype: str = "float32"        # compute dtype for the decoder matmuls
    fused_gather: str = "auto"    # "auto" | "mfv" | "off" in this port
                                  # ("on" | "table" | "full" are not ported yet)

    @classmethod
    def from_json(cls, s: str) -> "DPDistConfig":
        d = json.loads(s)
        # JSON has no tuples; restore them so the config stays hashable.
        d = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
        return cls(**d)

    def replace(self, **kw) -> "DPDistConfig":
        return dataclasses.replace(self, **kw)

    @property
    def grid_size(self) -> int:
        if self.dims == 2:
            g = round(self.embedding_size ** 0.5)
            if g * g != self.embedding_size:
                raise ValueError(
                    f"embedding_size must be a square for dims=2, got {self.embedding_size}")
            return g
        g = round(self.embedding_size ** (1.0 / 3.0))
        if g ** 3 != self.embedding_size:
            raise ValueError(f"embedding_size must be a cube, got {self.embedding_size}")
        return g

    @property
    def fv_channels(self) -> int:
        # d_pi: mean(+max); d_mu, d_sigma: mean(+max+min) each, D dims.
        if self.full_fv:
            return 2 + 3 * self.dims + 3 * self.dims
        return 1 + self.dims + self.dims

    @property
    def patch_dim(self) -> int:
        if self.encoder == "pointnet":
            return self.pointnet_embedding
        if self.k == 0:
            return self.fv_channels * self.embedding_size
        return self.fv_channels * self.k ** self.dims
