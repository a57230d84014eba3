"""Pairwise point-cloud distance evaluation with the learned DPDist distance
(port of dpdist_tpu/cli/eval_pair.py; the chamfer and EMD keys come with
the port of ops/chamfer.py and ops/emd.py).

    python -m dpdist_tpu_torch.cli.eval_pair --dpdist_ckpt results/ckpt_best

It scores two synthetic chairs (seed, seed+1) of --num_point points,
scaled by 0.8, as the reference CLI does without input files. Runs on the
card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import json

import torch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dpdist_ckpt", required=True)
    p.add_argument("--num_point", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)

    from dpdist_tpu_torch.data.synthetic import synthetic_surface
    from dpdist_tpu_torch.serving import load_frozen_distance

    model = load_frozen_distance(a.dpdist_ckpt, device=a.device)
    dev = next(model.parameters()).device
    pcA, pcB = (
        torch.as_tensor(synthetic_surface("chair", seed=s, n_points=a.num_point)[None] * 0.8,
                        dtype=torch.float32, device=dev)
        for s in (a.seed, a.seed + 1))
    print(json.dumps({"dpdist": float(model(pcA, pcB).mean())}, indent=2))


if __name__ == "__main__":
    main()
