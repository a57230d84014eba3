"""Train DPDist (port of dpdist_tpu/cli/train_dpdist.py; the original is
train_multi_gpu_pc_compare_dist.py, phase 1).

    python -m dpdist_tpu_torch.cli.train_dpdist --data_root data/synthetic \
        --log_dir runs/dpdist --max_epoch 201 [--dtype bfloat16] [--resume]
    python -m dpdist_tpu_torch.cli.train_dpdist --device cpu ...

Trains on the card unless --device cpu is given, from a dataset that
gen_data wrote; under torchrun data-parallel, one process per card
(--data_parallel 0 takes every process; rank 0 writes the checkpoints and
logs):

    torchrun --nproc_per_node 4 -m dpdist_tpu_torch.cli.train_dpdist ...

--resume restores the newest checkpoint under --log_dir; --archive_to
copies ckpt_best to a base path on every improvement. Its checkpoints load
in serving.load_frozen_distance and in the JAX package's
restore_checkpoint.
"""

from __future__ import annotations

import argparse

from dpdist_tpu_torch.cli.common import (
    add_device_arg,
    add_dpdist_model_args,
    add_train_args,
    mesh_from_args,
    dpdist_config_from_args,
    train_config_from_args,
)
from dpdist_tpu_torch.parallel import initialize_distributed


def main(argv=None):
    """Run the CLI; returns the trainer."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_dpdist_model_args(p)
    add_train_args(p)
    p.add_argument("--data_root", default="data/synthetic")
    p.add_argument("--category", default="chair",
                   help="class filter; 'all' trains on every class")
    p.add_argument("--log_dir", default="runs/dpdist")
    p.add_argument("--eval_every", type=int, default=10)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--archive_to", default=None,
                   help="base path (no extension) to copy ckpt_best to on every "
                        "improvement, e.g. results/dpdist_multi")
    add_device_arg(p)
    a = p.parse_args(argv)
    initialize_distributed(device=a.device)
    mesh = mesh_from_args(a)

    from dpdist_tpu_torch.data.modelnet import SurfacePairDataset
    from dpdist_tpu_torch.train.trainer import DPDistTrainer

    mcfg = dpdist_config_from_args(a)
    tcfg = train_config_from_args(a)
    trainer = DPDistTrainer(mcfg, tcfg, run_dir=a.log_dir, mesh=mesh, device=a.device)
    if a.resume:
        trainer.restore()

    category = None if a.category == "all" else a.category
    train_ds = SurfacePairDataset(a.data_root, batch_size=tcfg.batch_size,
                                  npoints=mcfg.num_point * 2, split="train",
                                  class_choice=category, seed=a.seed)
    test_ds = SurfacePairDataset(a.data_root, batch_size=tcfg.batch_size,
                                 npoints=mcfg.num_point * 2, split="test",
                                 class_choice=category, seed=a.seed)
    trainer.fit(train_ds, test_ds, eval_every=a.eval_every, archive_to=a.archive_to)
    return trainer


if __name__ == "__main__":
    main()
