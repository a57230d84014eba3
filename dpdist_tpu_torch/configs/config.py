"""Model and training configuration (port of DPDistConfig, AUEConfig,
PCRNetConfig and TrainConfig from dpdist_tpu/configs/config.py).

Same field names, defaults and JSON form as the reference dataclasses, so
the `model_config` (DPDist), `aue_config` (AUE) or `pcrnet_config` (PCRNet)
string stored in a checkpoint's metadata parses into either package, and
either package writes one the other reads.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Tuple


class _JsonMixin:
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str):
        d = json.loads(s)
        # JSON has no tuples; restore them so the config stays hashable.
        d = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
        return cls(**d)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class DPDistConfig(_JsonMixin):
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
    dtype: str = "float32"        # decoder and patch dtype: "float32" | "bfloat16" | "float16"
    fused_gather: str = "auto"    # "auto" | "mfv" | "table" | "on" | "full" | "off"

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


@dataclass(frozen=True)
class AUEConfig(_JsonMixin):
    """Point-cloud autoencoder (reference models/dpdist_and_aue.py:88-180)."""

    num_point: int = 64
    encoder: str = "pn"           # "pn" (PointNet AE) | "3dmfv" (inception decoder)
    n_gaussians: int = 512
    use_bn: bool = True           # the reference's AUE always uses BN


@dataclass(frozen=True)
class PCRNetConfig(_JsonMixin):
    """Iterative PCRNet (reference pcrnet-registration/models/ipcr_model.py)."""

    num_point: int = 1024
    encoder: str = "pointnet"     # "pointnet" | "pointnet_avg" | "3dmfv"
    out_features: int = 1024
    max_loops: int = 8            # refinement loops during training
    eval_iterations: int = 50     # fixed eval refinement iterations
    lim_rot: float = 0.0          # >0: tanh-limited axis-angle head (degrees)
    head_widths: Tuple[int, ...] = (1024, 512, 256)
    dropout_keep: float = 0.7
    sigma3dmfv: float = 0.25      # 3dmfv encoder variant: sigma=0.0625*4
    mfv_grid: int = 8


@dataclass(frozen=True)
class TrainConfig(_JsonMixin):
    """Optimizer, schedule and runtime knobs of DPDist training."""

    batch_size: int = 16
    learning_rate: float = 1e-4   # --learning_rate_dpdist
    decay_step: int = 300 * 512   # staircase decay step
    decay_rate: float = 0.5
    lr_floor: float = 1e-7        # the reference clips the LR at 1e-7
    optimizer: str = "adam"       # "adam" | "momentum"
    momentum: float = 0.9
    weight_decay: float = 0.0     # L2 on dense kernels ("w") only
    grad_clip: float = 0.0        # >0: global-norm gradient clipping
    max_epoch: int = 10001
    bn_init_decay: float = 0.5
    bn_decay_rate: float = 0.5
    bn_decay_clip: float = 0.99
    loss_type: str = "l1_dist"
    augment: bool = True
    add_noise: float = 0.0        # stddev of Gaussian noise on the encoder's copy of pcA
    encoder_occlusion: float = 0.0        # fraction of points removed from the encoder's pcA
    encoder_occlusion_prob: float = 0.0   # per-item probability of encoder occlusion
    seed: int = 0
    log_every: int = 10
    checkpoint_every_epochs: int = 10


@dataclass(frozen=True)
class MeshConfig(_JsonMixin):
    """Device mesh layout (parallel.make_mesh).

    data:   the data-parallel axis: the batch is sharded over it and the
            gradients averaged by one all_reduce.
    points: the query-point axis of dense evaluation: each query is
            independent given the embedding, so N shards over it.
    """

    data: int = 1
    points: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.points
