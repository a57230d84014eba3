"""Train iterative PCRNet (port of dpdist_tpu/cli/train_pcrnet.py; the
originals are iterative_PCRNet_ours.py and iterative_PCRNet.py).

    python -m dpdist_tpu_torch.cli.train_pcrnet --loss_type dpdist \
        --dpdist_ckpt results/dpdist_multi_r4_ckpt_best --num_point 64 \
        --families chair sphere box cylinder torus --n_templates 125 \
        --sparse 1 --s_rand_points 1.0 --centroid_sub 0 --train_single \
        --grad_clip 1.0 --noise_prob 1.0 --select_family chair \
        --eval_cases 160 --max_epoch 1200 --log_dir runs/pcrnet

--loss_type dpdist trains on the frozen DPDist loss (on the card, its
table-gather and adjoint kernels); chamfer and emd are the baselines.
Runs on the card unless --device cpu is given; under torchrun
data-parallel, one process per card (--data_parallel 0 takes every
process, another value must equal the world size; rank 0 writes the
checkpoints and logs).
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


def main(argv=None):
    """Run the CLI; returns the trainer."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_train_args(p)
    p.add_argument("--loss_type", default="dpdist", choices=["dpdist", "chamfer", "emd"])
    p.add_argument("--dpdist_ckpt", default=None)
    p.add_argument("--num_point", type=int, default=1024)
    p.add_argument("--max_loops", type=int, default=8)
    p.add_argument("--out_features", type=int, default=1024)
    p.add_argument("--encoder", default="pointnet",
                   choices=["pointnet", "pointnet_avg", "3dmfv"],
                   help="siamese encoder (3dmfv: the 3DmFV volume through six 3D inception "
                        "blocks with BN)")
    p.add_argument("--families", nargs="+", default=["chair"])
    p.add_argument("--n_templates", type=int, default=16)
    p.add_argument("--max_rotate_deg", type=float, default=45.0)
    p.add_argument("--log_dir", default="runs/pcrnet")
    p.add_argument("--batches_per_epoch", type=int, default=32)
    p.add_argument("--s_rand_points", type=float, default=0.0)
    p.add_argument("--sparse", type=int, default=0, choices=[0, 1, 2],
                   help="disjoint template/source split (the canonical recipe uses 1)")
    p.add_argument("--centroid_sub", type=int, default=1,
                   help="subtract the source centroid (canonical recipe: 0)")
    p.add_argument("--noise_prob", type=float, default=0.0)
    p.add_argument("--occlusion_fraction", type=float, default=0.0,
                   help="train-time kNN-ball occlusion of sources")
    p.add_argument("--templates_h5", default=None, help="templates file (needs h5py)")
    p.add_argument("--resume", default=None, help="PCRNet checkpoint base path")
    p.add_argument("--action_reg", type=float, default=0.0,
                   help="L1 penalty on the pose magnitude of the late half of the "
                        "train_single rollout")
    p.add_argument("--fp_reg", type=float, default=0.0,
                   help="L1 penalty on the actions of a --fp_steps rollout started from "
                        "the ground-truth-aligned source")
    p.add_argument("--fp_steps", type=int, default=4,
                   help="rollout length of the fp_reg aligned-state rollout")
    p.add_argument("--train_single", action="store_true",
                   help="supervise every refinement iteration (full BPTT)")
    p.add_argument("--eval_cases", type=int, default=64,
                   help="in-training validation cases")
    p.add_argument("--select_family", default=None,
                   help="best-checkpoint selection on this family's eval slice")
    p.add_argument("--archive_to", default=None,
                   help="base path (no extension) to copy pcrnet_ckpt_best to on every "
                        "improvement")
    add_device_arg(p)
    a = p.parse_args(argv)
    initialize_distributed(device=a.device)
    mesh = mesh_from_args(a)

    from dpdist_tpu_torch.configs import PCRNetConfig
    from dpdist_tpu_torch.data.registration import RegistrationDataset
    from dpdist_tpu_torch.train.checkpoint import load_dpdist_checkpoint
    from dpdist_tpu_torch.train.pcrnet_trainer import PCRNetTrainer

    dpdist = None
    if a.loss_type == "dpdist":
        if not a.dpdist_ckpt:
            raise SystemExit("--loss_type dpdist requires --dpdist_ckpt")
        dpdist = load_dpdist_checkpoint(a.dpdist_ckpt)

    pcfg = PCRNetConfig(num_point=a.num_point, max_loops=a.max_loops,
                        out_features=a.out_features, encoder=a.encoder)
    tcfg = train_config_from_args(a)
    trainer = PCRNetTrainer(pcfg, tcfg, loss_type=a.loss_type, dpdist=dpdist,
                            train_single=a.train_single, action_reg=a.action_reg,
                            fp_reg=a.fp_reg, fp_steps=a.fp_steps, run_dir=a.log_dir,
                            mesh=mesh, device=a.device)
    if a.resume:
        trainer.restore(a.resume)
    ds_kw = dict(h5_path=a.templates_h5, families=tuple(a.families),
                 n_templates=a.n_templates, num_point=a.num_point,
                 max_rotate_deg=a.max_rotate_deg, sparse=a.sparse,
                 s_rand_points=a.s_rand_points, centroid_sub=bool(a.centroid_sub))
    ds = RegistrationDataset(seed=a.seed, **ds_kw)
    eval_ds = RegistrationDataset(seed=a.seed + 10 ** 6, **ds_kw)
    best = trainer.fit(ds, epochs=tcfg.max_epoch, batches_per_epoch=a.batches_per_epoch,
                       eval_dataset=eval_ds, eval_cases=a.eval_cases,
                       select_family=a.select_family, archive_to=a.archive_to,
                       random_points_prob=a.s_rand_points, noise_prob=a.noise_prob,
                       occlusion_fraction=a.occlusion_fraction)
    print(f"best checkpoint: {best}")
    return trainer


if __name__ == "__main__":
    main()
