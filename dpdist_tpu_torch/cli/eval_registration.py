"""Registration evaluation (port of dpdist_tpu/cli/eval_registration.py;
the original is results_itrPCRNet_no_stop.py).

    python -m dpdist_tpu_torch.cli.eval_registration \
        --ckpt results/policy_mf_tsn1200clip_dpdist_final --iterations 50 \
        --n_templates 125 --families chair sphere box cylinder torus \
        --sparse 1 --s_rand_points 1.0 --centroid_sub 0 --seed 777 \
        --pose_file default --stop_threshold 1e-3 --stop_period 2 \
        --stop_select period0

Fixed-iteration refinement, optionally with the convergence stop; writes
the report JSON, the per-case CSV and the per-iteration curves under
--report_dir and prints the report without its curves. Runs on the card
unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import json

from dpdist_tpu_torch.cli.common import add_device_arg


def add_dataset_args(p: argparse.ArgumentParser, *, n_templates: int, seed: int):
    """The registration dataset's flags, shared with eval_matrix."""
    p.add_argument("--num_cases", type=int, default=None,
                   help="default: all poses in --pose_file, else 512")
    p.add_argument("--families", nargs="+", default=["chair"])
    p.add_argument("--n_templates", type=int, default=n_templates)
    p.add_argument("--max_rotate_deg", type=float, default=45.0)
    p.add_argument("--seed", type=int, default=seed)
    p.add_argument("--s_rand_points", type=float, default=0.0)
    p.add_argument("--sparse", type=int, default=0, choices=[0, 1, 2],
                   help="disjoint template/source split (the canonical recipe uses 1)")
    p.add_argument("--centroid_sub", type=int, default=1,
                   help="subtract the source centroid")
    p.add_argument("--pose_file", default=None,
                   help="fixed-pose CSV ('default' = the committed 5,070-pose set; "
                        "num_cases then defaults to all)")
    p.add_argument("--stop_threshold", type=float, default=None,
                   help="convergence stop: freeze each case once ||T@T_prev^-1 - I||_F^2 "
                        "< threshold")
    p.add_argument("--stop_period", type=int, default=1,
                   help="compare against the transform from N iterations back (2 detects "
                        "period-2 flip cycles)")
    p.add_argument("--stop_select", default="last", choices=["last", "chamfer", "period0"],
                   help="transform kept at convergence")
    add_device_arg(p)


def main(argv=None):
    """Run the CLI; returns the report."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt", required=True, help="PCRNetTrainer checkpoint base path")
    p.add_argument("--iterations", type=int, default=50)
    p.add_argument("--num_point", type=int, default=1024,
                   help="unused: the checkpoint's num_point is used, as in the reference")
    p.add_argument("--templates_h5", default=None, help="templates file (needs h5py)")
    p.add_argument("--report_dir", default="runs/registration_eval")
    p.add_argument("--use_noise_data", action="store_true",
                   help="per-point gaussian noise on sources")
    p.add_argument("--add_occlusions", type=float, default=0.0,
                   help="fraction of each source removed as a kNN ball")
    add_dataset_args(p, n_templates=16, seed=0)
    a = p.parse_args(argv)

    from dpdist_tpu_torch import resolve_device
    from dpdist_tpu_torch.cli.common import load_pcrnet_checkpoint_state, resolve_eval_cases
    from dpdist_tpu_torch.data.registration import (
        PerturbedRegistrationDataset,
        RegistrationDataset,
    )
    from dpdist_tpu_torch.eval.registration import evaluate_registration

    resolve_device(a.device)   # raise before reading or writing anything
    pcfg, params, state = load_pcrnet_checkpoint_state(a.ckpt)
    pose_file, num_cases = resolve_eval_cases(a.pose_file, a.num_cases)
    ds = RegistrationDataset(h5_path=a.templates_h5, families=tuple(a.families),
                             n_templates=a.n_templates, num_point=pcfg.num_point,
                             max_rotate_deg=a.max_rotate_deg, seed=a.seed, sparse=a.sparse,
                             s_rand_points=a.s_rand_points,
                             centroid_sub=bool(a.centroid_sub), pose_file=pose_file)
    if a.use_noise_data or a.add_occlusions > 0:
        ds = PerturbedRegistrationDataset(ds, noise=a.use_noise_data,
                                          occlusion_fraction=a.add_occlusions)
    report = evaluate_registration(params, pcfg, ds, num_cases=num_cases,
                                   iterations=a.iterations, report_dir=a.report_dir,
                                   stop_threshold=a.stop_threshold,
                                   stop_period=a.stop_period, stop_select=a.stop_select,
                                   state=state, device=a.device)
    print(json.dumps({k: v for k, v in report.items() if not k.startswith("curve_")},
                     indent=2))
    return report


if __name__ == "__main__":
    main()
