"""Shared CLI flags (port of dpdist_tpu/cli/common.py): the same flags and
defaults, plus --device, which takes the place of the reference's
DPDIST_PLATFORM hook (dpdist_tpu/cli/__init__.py, a JAX platform switch).

The training CLIs run data-parallel under torchrun, one process per
device (parallel.initialize_distributed, then mesh_from_args):

    torchrun --nproc_per_node 4 -m dpdist_tpu_torch.cli.train_dpdist ...
"""

from __future__ import annotations

import argparse

from dpdist_tpu_torch.configs import DPDistConfig, PCRNetConfig, TrainConfig


def add_device_arg(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda",
                   help="torch device the entry point runs on (cuda, or cpu for the plain "
                        "PyTorch path); without a card, cuda raises")


def add_dpdist_model_args(p: argparse.ArgumentParser):
    """Flags mirroring train_multi_gpu_pc_compare_dist.py:41-69."""
    p.add_argument("--num_point", type=int, default=64)
    p.add_argument("--embedding_size", type=int, default=8 ** 3)
    p.add_argument("--sigma3dmfv", type=float, default=2.0,
                   help="sigma = this * 0.0625 (reference :103)")
    p.add_argument("--K", type=int, default=5)
    p.add_argument("--encoder", default="3dmfv", choices=["3dmfv", "pointnet"])
    p.add_argument("--full_fv", default="full", choices=["full", "small"])
    p.add_argument("--implicit_net_type", type=int, default=1, choices=[1, 3])
    p.add_argument("--BN", type=int, default=0)
    p.add_argument("--mlp", type=int, nargs="+", default=[1024, 1024, 1024])
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="decoder and patch compute dtype (bfloat16 halves the decoder "
                        "input's bytes; the 3DmFV math stays float32)")


def dpdist_config_from_args(a) -> DPDistConfig:
    return DPDistConfig(
        num_point=a.num_point,
        embedding_size=a.embedding_size,
        sigma=a.sigma3dmfv * 0.0625,
        full_fv=(a.full_fv == "full"),
        k=a.K,
        mlp=tuple(a.mlp),
        conv_version=a.implicit_net_type,
        encoder=a.encoder,
        use_bn=bool(a.BN),
        dtype=a.dtype,
    )


def add_train_args(p: argparse.ArgumentParser):
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--decay_step", type=int, default=300 * 512)
    p.add_argument("--decay_rate", type=float, default=0.5)
    p.add_argument("--optimizer", default="adam", choices=["adam", "momentum"])
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--grad_clip", type=float, default=0.0,
                   help="global-norm gradient clipping (0 = off)")
    p.add_argument("--max_epoch", type=int, default=201)
    p.add_argument("--add_noise", type=float, default=0.0)
    p.add_argument("--encoder_occlusion", type=float, default=0.0,
                   help="occlusion fraction applied to the ENCODER's conditioning cloud "
                        "(labels stay vs the true surface); trains an occlusion-robust "
                        "distance")
    p.add_argument("--encoder_occlusion_prob", type=float, default=0.0,
                   help="per-item probability of encoder occlusion")
    p.add_argument("--no_augment", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_parallel", type=int, default=0,
                   help="processes on the data axis: 0 for every process of the run "
                        "(torchrun's world; 1 without torchrun); any other value must "
                        "equal the world size")


def train_config_from_args(a) -> TrainConfig:
    return TrainConfig(
        batch_size=a.batch_size,
        learning_rate=a.learning_rate,
        decay_step=a.decay_step,
        decay_rate=a.decay_rate,
        optimizer=a.optimizer,
        momentum=a.momentum,
        weight_decay=a.weight_decay,
        grad_clip=getattr(a, "grad_clip", 0.0),
        max_epoch=a.max_epoch,
        add_noise=a.add_noise,
        encoder_occlusion=getattr(a, "encoder_occlusion", 0.0),
        encoder_occlusion_prob=getattr(a, "encoder_occlusion_prob", 0.0),
        augment=not a.no_augment,
        seed=a.seed,
    )


def mesh_from_args(a):
    """The data-parallel mesh of --data_parallel on --device: 0 puts every
    process of the run on the data axis; another value that is not the
    world size raises ValueError (one process per device)."""
    from dpdist_tpu_torch.parallel import make_mesh
    from dpdist_tpu_torch.parallel.distributed import world_size

    return make_mesh(data=a.data_parallel if a.data_parallel > 0 else world_size(),
                     device=a.device)


def load_pcrnet_checkpoint_state(path: str):
    """(cfg, params, state) of a PCRNetTrainer checkpoint of either package;
    params and state hold numpy arrays in the JAX package's trees (the
    pointnet policies' state is {}; a 3dmfv checkpoint without a state
    gives None, which normalises with batch statistics)."""
    import json

    import torch

    from dpdist_tpu_torch.models.pcrnet import init_pcrnet, init_pcrnet_state
    from dpdist_tpu_torch.train.checkpoint import restore_params_maybe_state

    with open(path + ".json") as f:
        meta = json.load(f)["metadata"]
    cfg = PCRNetConfig.from_json(meta["pcrnet_config"])
    template = init_pcrnet(cfg, torch.Generator().manual_seed(0), "cpu")
    params, state, _ = restore_params_maybe_state(path, template, init_pcrnet_state(cfg, "cpu"))
    return cfg, params, state


def load_pcrnet_checkpoint(path: str):
    """(cfg, params) of load_pcrnet_checkpoint_state."""
    return load_pcrnet_checkpoint_state(path)[:2]


def resolve_eval_cases(pose_file, num_cases):
    """(pose_file, num_cases) of the registration evaluators: pose_file
    "default" is the committed 5,070-pose set; num_cases defaults to every
    pose of the file, else 512."""
    from dpdist_tpu_torch.data.io import read_pose_csv
    from dpdist_tpu_torch.data.registration import default_eval_poses

    if pose_file == "default":
        pose_file = default_eval_poses()
    if num_cases is None:
        num_cases = len(read_pose_csv(pose_file)) if pose_file is not None else 512
    return pose_file, num_cases
