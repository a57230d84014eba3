"""Generate a ground-truth distance dataset (port of dpdist_tpu/cli/gen_data.py;
the original is dataset_sample_with_gt.py).

    python -m dpdist_tpu_torch.cli.gen_data --out data/synthetic --n_train 16 --n_test 4
    python -m dpdist_tpu_torch.cli.gen_data --device cpu ...

Synthetic mode builds surfaces from the built-in parametric families; with
--from_modelnet it processes ModelNet40 resampled txt files laid out as
<root>/<class>/<id>.txt. The distances run on the card (the NN-min kernel)
unless --device cpu is given, where they run on the native host library
as in the reference, and the files are then byte for byte the reference's.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from dpdist_tpu_torch.cli.common import add_device_arg
from dpdist_tpu_torch.data.synthetic import stable_seed


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default="data/synthetic")
    p.add_argument("--families", nargs="+", default=["chair"])
    p.add_argument("--n_train", type=int, default=16)
    p.add_argument("--n_test", type=int, default=4)
    p.add_argument("--n_surface", type=int, default=10000)
    p.add_argument("--num_neg_points", type=int, default=10 ** 4)
    p.add_argument("--eps", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scheme", default="dropped_coordinates",
                   help="query sampler: dropped_coordinates (the default, unit ball) / cube / "
                        "muller / polar / exponential (dataset_sample_with_gt.py:141-188)")
    p.add_argument("--from_modelnet", default=None,
                   help="process real ModelNet40 txt files from this root")
    p.add_argument("--category", default=None)
    add_device_arg(p)
    a = p.parse_args(argv)

    from dpdist_tpu_torch import resolve_device

    device = resolve_device(a.device)
    t0 = time.time()
    if a.from_modelnet:
        from dpdist_tpu_torch.data.gtgen import generate_gt_for_points, write_reference_format

        root = a.from_modelnet
        for split in ("train", "test"):
            ids = [l.rstrip() for l in open(os.path.join(root, f"modelnet40_{split}.txt"))]
            for sid in ids:
                name = "_".join(sid.split("_")[:-1])
                if a.category and name != a.category:
                    continue
                base = os.path.join(root, name, sid)
                if os.path.exists(base + "_dist_c_scaled.txt"):
                    continue
                pts = np.loadtxt(base + ".txt", delimiter=",").astype(np.float32)
                rng = np.random.default_rng(a.seed + stable_seed(sid) % 10 ** 6)
                surface, near, far = generate_gt_for_points(
                    pts, eps=a.eps, num_neg_points=a.num_neg_points, rng=rng, scheme=a.scheme,
                    device=device)
                write_reference_format(base, surface, near, far, a.num_neg_points)
                print(f"{sid}: done ({time.time() - t0:.1f}s)")
    else:
        from dpdist_tpu_torch.data.gtgen import generate_synthetic_dataset

        generate_synthetic_dataset(
            a.out, families=tuple(a.families), n_train=a.n_train, n_test=a.n_test,
            n_surface=a.n_surface, num_neg_points=a.num_neg_points, eps=a.eps, seed=a.seed,
            scheme=a.scheme, device=device)
        print(f"synthetic dataset written to {a.out} ({time.time() - t0:.1f}s)")


if __name__ == "__main__":
    main()
