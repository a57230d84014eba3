"""Train the autoencoder on the frozen DPDist (or chamfer) loss (port of
dpdist_tpu/cli/train_aue.py; the original is
train_multi_gpu_pc_compare_dist.py's phases 2 and 3, --train_comp other
than dpdist).

    python -m dpdist_tpu_torch.cli.train_aue --dpdist_ckpt results/ckpt_best \
        --opt_type ours --encoder_aue 3dmfv --num_point 64 \
        --data_root data/synthetic --category chair --log_dir runs/aue

The learning rate is max(--learning_rate, 1e-3), as the reference's. Runs
on the card unless --device cpu is given; under torchrun data-parallel,
one process per card (--data_parallel 0 takes every process, another
value must equal the world size; rank 0 writes the checkpoints and logs).
"""

from __future__ import annotations

import argparse

from dpdist_tpu_torch.cli.common import (
    add_device_arg,
    add_train_args,
    mesh_from_args,
    train_config_from_args,
)
from dpdist_tpu_torch.parallel import initialize_distributed
from dpdist_tpu_torch.train.checkpoint import load_dpdist_checkpoint

__all__ = ["load_dpdist_checkpoint", "main"]


def main(argv=None):
    """Run the CLI; returns the trainer."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_train_args(p)
    p.add_argument("--dpdist_ckpt", required=True,
                   help="base path of a DPDistTrainer checkpoint")
    p.add_argument("--opt_type", default="ours", choices=["ours", "chamfer"])
    p.add_argument("--encoder_aue", default="pn", choices=["pn", "3dmfv"])
    p.add_argument("--num_point", type=int, default=64)
    p.add_argument("--data_root", default="data/synthetic")
    p.add_argument("--category", default="chair")
    p.add_argument("--log_dir", default="runs/aue")
    p.add_argument("--max_epoch_aue", type=int, default=100)
    p.add_argument("--resume", default=None, help="AUE checkpoint base path")
    p.add_argument("--start_epoch", type=int, default=0,
                   help="with --resume: continue epoch numbering from here (the total "
                        "budget stays --max_epoch_aue)")
    p.add_argument("--archive_to", default=None,
                   help="base path (no extension) to copy aue_ckpt_best to on every "
                        "improvement")
    add_device_arg(p)
    a = p.parse_args(argv)
    initialize_distributed(device=a.device)
    mesh = mesh_from_args(a)

    from dpdist_tpu_torch import resolve_device
    from dpdist_tpu_torch.configs import AUEConfig
    from dpdist_tpu_torch.data.modelnet import SurfacePairDataset
    from dpdist_tpu_torch.train.aue_trainer import AUETrainer

    resolve_device(a.device)   # raise before reading or writing anything
    dcfg, dparams, dstate = load_dpdist_checkpoint(a.dpdist_ckpt)
    tcfg = train_config_from_args(a).replace(learning_rate=max(a.learning_rate, 1e-3))
    acfg = AUEConfig(num_point=a.num_point, encoder=a.encoder_aue)
    trainer = AUETrainer(acfg, tcfg, dcfg, dparams, dstate, opt_type=a.opt_type,
                         run_dir=a.log_dir, mesh=mesh, device=a.device)
    if a.resume:
        trainer.restore(a.resume)
    ds, test_ds = (SurfacePairDataset(a.data_root, batch_size=tcfg.batch_size,
                                      npoints=a.num_point * 2, split=split,
                                      class_choice=a.category, seed=a.seed)
                   for split in ("train", "test"))
    best = trainer.fit(ds, test_ds, max_epoch=a.max_epoch_aue, start_epoch=a.start_epoch,
                       archive_to=a.archive_to)
    print(f"best checkpoint: {best}")
    return trainer


if __name__ == "__main__":
    main()
