"""Compare DPDist, chamfer and EMD sensitivity on perturbation sweeps (port
of dpdist_tpu/cli/compare_losses.py).

    python -m dpdist_tpu_torch.cli.compare_losses --dpdist_ckpt results/ckpt_best \
        --out report.json

The paper-style comparison table: for each perturbation kind and
magnitude, the mean score of each metric, and the resample-invariance
check (two samplings of one surface should score near zero). The report
JSON has the reference's form. Runs on the card unless --device cpu is
given.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from dpdist_tpu_torch.cli.common import add_device_arg


def main(argv=None):
    """Run the CLI; returns the report."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dpdist_ckpt", required=True)
    p.add_argument("--families", nargs="+", default=["chair"])
    p.add_argument("--n_surfaces", type=int, default=8)
    p.add_argument("--num_point", type=int, default=64)
    p.add_argument("--kinds", nargs="+",
                   default=["resample", "noise", "deform", "translate", "occlude"])
    p.add_argument("--out", default=None, help="write the JSON report here")
    p.add_argument("--seed", type=int, default=0)
    add_device_arg(p)
    a = p.parse_args(argv)

    from dpdist_tpu_torch import resolve_device
    from dpdist_tpu_torch.data.synthetic import synthetic_surface
    from dpdist_tpu_torch.eval.comparison import monotonicity, perturbation_sweep
    from dpdist_tpu_torch.train.checkpoint import load_dpdist_checkpoint, params_from_jax

    dev = resolve_device(a.device)
    cfg, params, state = load_dpdist_checkpoint(a.dpdist_ckpt)
    params, state = params_from_jax(params, dev), params_from_jax(state, dev)
    surfaces = np.stack([
        synthetic_surface(a.families[i % len(a.families)], seed=a.seed + i,
                          n_points=max(4 * a.num_point, 512)) * 0.8
        for i in range(a.n_surfaces)])

    report = {}
    for kind in a.kinds:
        mags = ([0.0] if kind == "resample"
                else [0.0, 0.1, 0.25, 0.5] if kind == "occlude"
                else [0.0, 0.02, 0.05, 0.1, 0.2])
        sweep = perturbation_sweep(params, cfg, surfaces, kind=kind, magnitudes=mags,
                                   num_point=a.num_point, seed=a.seed, device=dev, state=state)
        sweep["dpdist_monotonicity"] = monotonicity(sweep["dpdist"])
        report[kind] = sweep
        print(f"== {kind} ==")
        print("  mag    dpdist   chamfer    emd")
        for i, m in enumerate(sweep["magnitudes"]):
            print(f"  {m:5.2f}  {sweep['dpdist'][i]:8.4f} "
                  f"{sweep['chamfer'][i]:8.4f} {sweep['emd'][i]:8.4f}")

    if a.out:
        with open(a.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"report written to {a.out}")
    return report


if __name__ == "__main__":
    main()
