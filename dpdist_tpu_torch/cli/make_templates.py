"""Create registration templates (h5) and pose CSVs (port of
dpdist_tpu/cli/make_templates.py; the originals are
utils/data_txt_to_hdf5.py and utils/create_dataset/generate_poses_ours.py).

    python -m dpdist_tpu_torch.cli.make_templates --out_dir data/registration \
        --families chair --n_templates 16 --num_point 2048

Templates come from dense ground-truth surfaces
(<data_root>/<category>/<id>_dist_c_scaled.txt) or from the synthetic
families. Writes templates_{train,test,eval}.h5 (needs h5py), files.txt
and itr_net_{split}_data<deg>.csv, the same files the reference writes
for the same flags. numpy only: --device is accepted for the CLIs'
uniformity and checked, nothing runs on it.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from dpdist_tpu_torch.cli.common import add_device_arg
from dpdist_tpu_torch.data.synthetic import stable_seed


def main(argv=None):
    """Run the CLI; returns the templates (T, N, 3)."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out_dir", default="data/registration")
    p.add_argument("--data_root", default=None,
                   help="ground-truth dataset root; falls back to synthetic surfaces")
    p.add_argument("--category", default="chair")
    p.add_argument("--families", nargs="+", default=["chair"])
    p.add_argument("--n_templates", type=int, default=16)
    p.add_argument("--num_point", type=int, default=2048)
    p.add_argument("--num_poses", type=int, default=5070)
    p.add_argument("--max_rotate_deg", type=float, default=45.0)
    p.add_argument("--seed", type=int, default=0)
    add_device_arg(p)
    a = p.parse_args(argv)

    from dpdist_tpu_torch import resolve_device
    from dpdist_tpu_torch.data.io import write_pose_csv, write_templates_h5
    from dpdist_tpu_torch.data.registration import generate_poses

    resolve_device(a.device)
    os.makedirs(a.out_dir, exist_ok=True)
    names = []
    if a.data_root:
        from dpdist_tpu_torch.data.io import read_xyz_txt

        paths = sorted(glob.glob(os.path.join(a.data_root, a.category,
                                              "*_dist_c_scaled.txt")))
        tmpl = []
        for path in paths[: a.n_templates]:
            pts = read_xyz_txt(path)
            if len(pts) < a.num_point:
                continue
            tmpl.append(pts[: a.num_point])
            names.append(os.path.basename(path))
        templates = np.stack(tmpl)
    else:
        from dpdist_tpu_torch.data.synthetic import synthetic_surface

        templates = np.stack([
            synthetic_surface(a.families[i % len(a.families)], seed=a.seed + i,
                              n_points=a.num_point)
            for i in range(a.n_templates)
        ])
        names = [f"{a.families[i % len(a.families)]}_{i}" for i in range(a.n_templates)]

    for split in ("train", "test", "eval"):
        write_templates_h5(os.path.join(a.out_dir, f"templates_{split}.h5"), templates, names)
        rng = np.random.default_rng(a.seed + stable_seed(split) % 1000)
        poses = generate_poses(a.num_poses, max_rotate_deg=a.max_rotate_deg, rng=rng)
        write_pose_csv(os.path.join(a.out_dir,
                                    f"itr_net_{split}_data{int(a.max_rotate_deg)}.csv"), poses)
    print(f"templates {templates.shape} + pose CSVs written to {a.out_dir}")
    return templates


if __name__ == "__main__":
    main()
