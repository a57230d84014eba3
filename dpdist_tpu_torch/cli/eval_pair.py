"""Pairwise point-cloud distance evaluation: the learned DPDist distance,
chamfer and EMD of two clouds (port of dpdist_tpu/cli/eval_pair.py).

    python -m dpdist_tpu_torch.cli.eval_pair --dpdist_ckpt results/ckpt_best \
        --cloud_a A.txt --cloud_b B.txt --num_point 10000

With --cloud_a and --cloud_b it reads two csv files of xyz rows and keeps
the first min(N_A, N_B, --num_point) points of each, as the reference
does; without them it scores two synthetic chairs (seed, seed+1) of
--num_point points, scaled by 0.8. It prints {"dpdist", "chamfer", "emd"}
as JSON. Runs on the card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def main(argv=None):
    """Run the CLI; returns the printed dict."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dpdist_ckpt", required=True)
    p.add_argument("--cloud_a", default=None, help="txt file (csv xyz rows)")
    p.add_argument("--cloud_b", default=None)
    p.add_argument("--num_point", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)

    from dpdist_tpu_torch.ops.chamfer import chamfer_distance
    from dpdist_tpu_torch.ops.emd import earth_mover_distance
    from dpdist_tpu_torch.serving import load_frozen_distance

    model = load_frozen_distance(a.dpdist_ckpt, device=a.device)
    dev = next(model.parameters()).device
    if a.cloud_a and a.cloud_b:
        pcA = np.loadtxt(a.cloud_a, delimiter=",")[:, :3][None]
        pcB = np.loadtxt(a.cloud_b, delimiter=",")[:, :3][None]
        n = min(pcA.shape[1], pcB.shape[1], a.num_point)
        pcA, pcB = pcA[:, :n], pcB[:, :n]
    else:
        from dpdist_tpu_torch.data.synthetic import synthetic_surface

        pcA, pcB = (synthetic_surface("chair", seed=s, n_points=a.num_point)[None] * 0.8
                    for s in (a.seed, a.seed + 1))
    pcA, pcB = (torch.as_tensor(x.astype(np.float32), device=dev) for x in (pcA, pcB))
    with torch.no_grad():
        out = {"dpdist": float(model(pcA, pcB).mean()),
               "chamfer": float(chamfer_distance(pcA, pcB)),
               "emd": float(earth_mover_distance(pcA, pcB))}
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
