"""Run a frozen serving program on point clouds: the consumer side of the
meta-graph handoff (port of dpdist_tpu/cli/run_serving.py).

The reference's downstream processes reload the frozen net with
`tf.train.import_meta_graph(... input_map=...)` and sess.run it
(iterative_PCRNet_ours.py:229-245); this CLI is that import side for the
torch.export programs written by `cli.export_serving`: load the program,
feed clouds from .ply/.npy/.xyz files (or a synthetic pair), and write the
outputs.

  # registration policy: (template, source) -> (T_pred, aligned)
  python -m dpdist_tpu_torch.cli.run_serving --artifact policy.pt2 \
      --template t.ply --source s.ply --out_aligned aligned.ply --out_json result.json

  # frozen distance (with d/d src when exported --with_grad)
  python -m dpdist_tpu_torch.cli.run_serving --artifact model.pt2 \
      --template t.ply --source s.ply

  # smoke / timing without files
  python -m dpdist_tpu_torch.cli.run_serving --artifact policy.pt2 --synthetic chair --bench 20

The served point count and a static batch come from the program's input
specs. A static batch is filled by repeating the last pair, and the
outputs are cut back to the pairs given. --device (cuda, or cpu) is where
the program runs; it is moved there when it was exported elsewhere (a
native program runs on the card only).
"""

from __future__ import annotations

import argparse
import json
import time

from dpdist_tpu_torch.cli.common import add_device_arg


def _read_cloud(path: str):
    import numpy as np

    if path.endswith(".npy"):
        pts = np.load(path)
    elif path.endswith(".ply"):
        from dpdist_tpu_torch.data.io import read_ply

        pts = read_ply(path)
    else:
        from dpdist_tpu_torch.data.io import read_xyz_txt

        pts = read_xyz_txt(path)
    pts = np.asarray(pts, np.float32)
    if pts.ndim == 2:
        pts = pts[None]
    if pts.ndim != 3 or pts.shape[-1] != 3:
        raise SystemExit(f"{path}: expected (N, 3) or (B, N, 3) points, got {pts.shape}")
    return pts


def _fit_points(pts, n: int, *, resample: bool, what: str):
    """Match the program's per-cloud point count."""
    import numpy as np

    if pts.shape[1] == n:
        return pts
    if pts.shape[1] > n and resample:
        idx = np.random.default_rng(0).permutation(pts.shape[1])[:n]
        return pts[:, idx]
    raise SystemExit(f"{what} has {pts.shape[1]} points but the program serves {n}-point "
                     "clouds; pass --resample to subsample (inputs with fewer points cannot "
                     "be upsampled)")


def main(argv=None):
    """Run the CLI; returns the result dict (the printed line and the T_pred
    the JSON file holds)."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--artifact", required=True, help="file written by cli.export_serving")
    p.add_argument("--template", default=None,
                   help=".ply/.npy/.xyz cloud (the target for distance programs)")
    p.add_argument("--source", default=None)
    p.add_argument("--synthetic", default=None, metavar="FAMILY",
                   help="generate a template/source pair from a synthetic family "
                        "(chair/sphere/box/cylinder/torus) instead of reading files")
    p.add_argument("--max_rotate_deg", type=float, default=45.0,
                   help="synthetic: pose magnitude of the source")
    p.add_argument("--resample", action="store_true",
                   help="random-subsample inputs to the program's point count when they "
                        "have more points")
    p.add_argument("--out_aligned", default=None,
                   help="registration: write the aligned source cloud (.ply or .npy)")
    p.add_argument("--out_json", default=None,
                   help="write outputs (transform / distances) as JSON")
    p.add_argument("--bench", type=int, default=0, metavar="N",
                   help="also time N repeat calls (after one warm-up)")
    add_device_arg(p)
    a = p.parse_args(argv)

    import numpy as np
    import torch

    from dpdist_tpu_torch import resolve_device
    from dpdist_tpu_torch.serving import exported_inputs, load_exported

    dev = resolve_device(a.device)
    ep = load_exported(a.artifact, device=dev)
    static_batch, npoint = exported_inputs(ep)
    program = ep.module()

    if a.synthetic:
        from dpdist_tpu_torch.data.registration import RegistrationDataset

        ds = RegistrationDataset(families=(a.synthetic,), n_templates=4, num_point=npoint,
                                 max_rotate_deg=a.max_rotate_deg, seed=0, sparse=1,
                                 s_rand_points=1.0, centroid_sub=False)
        template, source, _ = ds.sample_batch(static_batch or 1)
    elif a.template and a.source:
        template = _fit_points(_read_cloud(a.template), npoint, resample=a.resample,
                               what="--template")
        source = _fit_points(_read_cloud(a.source), npoint, resample=a.resample,
                             what="--source")
        if template.shape[0] != source.shape[0]:
            raise SystemExit("template and source batch sizes differ: "
                             f"{template.shape[0]} vs {source.shape[0]}")
    else:
        raise SystemExit("pass --template AND --source, or --synthetic")

    # A static batch: repeat the last pair, then cut the outputs back.
    true_b = template.shape[0]
    if static_batch is not None and true_b != static_batch:
        if true_b > static_batch:
            raise SystemExit(f"the program serves batch={static_batch}, got {true_b} pairs; "
                             "split the input")
        pad = static_batch - true_b
        template = np.concatenate([template, template[-1:].repeat(pad, 0)])
        source = np.concatenate([source, source[-1:].repeat(pad, 0)])
    tpl_t, src_t = (torch.as_tensor(np.ascontiguousarray(x, np.float32), device=dev)
                    for x in (template, source))

    def call():
        with torch.no_grad():
            outs = program(tpl_t, src_t)
        return outs if isinstance(outs, (tuple, list)) else (outs,)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    outs = [o.cpu().numpy()[:true_b] for o in call()]
    first_ms = 1e3 * (time.perf_counter() - t0)

    is_registration = outs[0].ndim == 3 and outs[0].shape[-2:] == (4, 4)
    result = {"artifact": a.artifact, "batch": true_b, "num_point": npoint,
              "device": str(dev), "first_call_ms": round(first_ms, 2)}
    if is_registration:
        from dpdist_tpu_torch.geometry.rotations import matrix_to_euler_zyx

        T_pred, aligned = outs[0], outs[1]
        result["T_pred"] = T_pred.tolist()
        angles = matrix_to_euler_zyx(torch.as_tensor(T_pred[:, :3, :3]))
        result["euler_deg"] = np.degrees(np.stack([x.numpy() for x in angles], -1)).tolist()
        result["translation"] = T_pred[:, :3, 3].tolist()
        if a.out_aligned:
            if a.out_aligned.endswith(".npy"):
                np.save(a.out_aligned, aligned)
            else:
                from dpdist_tpu_torch.data.io import write_ply

                write_ply(a.out_aligned, aligned[0])
            result["out_aligned"] = a.out_aligned
    else:
        result["distance"] = outs[0].reshape(-1).tolist()
        if len(outs) > 1:   # exported --with_grad
            result["grad_norm_per_pair"] = np.linalg.norm(
                outs[1].reshape(true_b, -1), axis=-1).tolist()

    if a.bench:
        call()   # warm-up
        sync()
        t0 = time.perf_counter()
        for _ in range(a.bench):
            call()
        sync()
        result["bench_ms_per_call"] = round(1e3 * (time.perf_counter() - t0) / a.bench, 3)

    if a.out_json:
        with open(a.out_json, "w") as f:
            json.dump(result, f, indent=1)
    # A compact console line: the full 4x4s live in --out_json.
    print(json.dumps({k: v for k, v in result.items() if k != "T_pred"}))
    return result


if __name__ == "__main__":
    main()
