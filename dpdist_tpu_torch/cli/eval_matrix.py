"""Evaluate several PCRNet checkpoints under several conditions in one
process (port of dpdist_tpu/cli/eval_matrix.py).

    python -m dpdist_tpu_torch.cli.eval_matrix \
        --ckpts chamfer=<base> dpdist=<base> \
        --conditions clean noise occl --out_dir runs/matrix_eval ...

Each (checkpoint, condition) cell writes <name>_<cond>.json and its report
directory under --out_dir, and prints one row for the whole and one per
family; summary.txt collects the rows. --skip_existing reuses cells
already written. Runs on the card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import json
import os

from dpdist_tpu_torch.cli.eval_registration import add_dataset_args


def _row(name, cond, tag, r):
    return (f"{name:10s} {cond:6s} {tag:10s} "
            f"rot {r['rot_err_mean_deg']:7.2f} "
            f"trans {r['trans_err_mean']:.4f} "
            f"acc2.5 {r['acc_rot2.5_trans0.05']:.3f} "
            f"acc5 {r['acc_rot5.0_trans0.05']:.3f} "
            f"acc10 {r['acc_rot10.0_trans0.1']:.3f} "
            f"acc20 {r['acc_rot20.0_trans0.2']:.3f}")


def main(argv=None):
    """Run the CLI; returns {cell name: report}."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpts", nargs="+", required=True, help="name=checkpoint_base pairs")
    p.add_argument("--conditions", nargs="+", default=["clean"],
                   choices=["clean", "noise", "occl"], type=str)
    p.add_argument("--occlusion_fraction", type=float, default=0.25)
    p.add_argument("--iterations", type=int, default=8)
    p.add_argument("--num_point", type=int, default=None,
                   help="defaults to the checkpoint's num_point")
    p.add_argument("--out_dir", default="runs/matrix_eval")
    p.add_argument("--skip_existing", action="store_true",
                   help="reuse per-cell JSONs already in out_dir")
    add_dataset_args(p, n_templates=64, seed=777)
    a = p.parse_args(argv)

    from dpdist_tpu_torch import resolve_device
    from dpdist_tpu_torch.cli.common import load_pcrnet_checkpoint_state, resolve_eval_cases
    from dpdist_tpu_torch.data.registration import (
        PerturbedRegistrationDataset,
        RegistrationDataset,
    )
    from dpdist_tpu_torch.eval.registration import evaluate_registration

    resolve_device(a.device)   # raise before reading or writing anything
    pose_file, num_cases = resolve_eval_cases(a.pose_file, a.num_cases)
    os.makedirs(a.out_dir, exist_ok=True)
    rows, reports = [], {}
    for spec in a.ckpts:
        name, _, base = spec.partition("=")
        if not base:
            name, base = os.path.basename(spec), spec
        cfg, params, state = load_pcrnet_checkpoint_state(base)
        for cond in a.conditions:
            cell_json = os.path.join(a.out_dir, f"{name}_{cond}.json")
            if a.skip_existing and os.path.exists(cell_json):
                with open(cell_json) as f:
                    rep = json.load(f)
                cached = "  (cached)"
            else:
                ds = RegistrationDataset(
                    families=tuple(a.families), n_templates=a.n_templates,
                    num_point=a.num_point or cfg.num_point,
                    max_rotate_deg=a.max_rotate_deg, seed=a.seed, sparse=a.sparse,
                    s_rand_points=a.s_rand_points, centroid_sub=bool(a.centroid_sub),
                    pose_file=pose_file)
                if cond != "clean":
                    ds = PerturbedRegistrationDataset(
                        ds, noise=(cond == "noise"),
                        occlusion_fraction=a.occlusion_fraction if cond == "occl" else 0.0)
                rep = evaluate_registration(
                    params, cfg, ds, num_cases=num_cases, iterations=a.iterations,
                    stop_threshold=a.stop_threshold,
                    stop_period=a.stop_period, stop_select=a.stop_select,
                    report_dir=os.path.join(a.out_dir, f"eval_{name}_{cond}"),
                    state=state, device=a.device)
                with open(cell_json, "w") as f:
                    json.dump(rep, f, indent=2)
                cached = ""
            reports[f"{name}_{cond}"] = rep
            for tag, r in [("all", rep)] + list(rep.get("per_family", {}).items()):
                row = _row(name, cond, tag, r)
                rows.append(row)
                print(row + cached, flush=True)
    with open(os.path.join(a.out_dir, "summary.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")
    return reports


if __name__ == "__main__":
    main()
