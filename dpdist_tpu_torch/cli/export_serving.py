"""Export a trained DPDist checkpoint (or a PCRNet policy) as a frozen
serving program (port of dpdist_tpu/cli/export_serving.py).

The torch.export counterpart of the reference's jax.export artifact (and
of its meta-graph handoff, iterative_PCRNet_ours.py:229-231): the written
program carries the weights and loads with torch alone; see
dpdist_tpu_torch/serving.py.

  python -m dpdist_tpu_torch.cli.export_serving --dpdist_ckpt results/ckpt_best \
      --out model.pt2 [--batch 256] [--with_grad] [--native_kernels] \
      [--num_point 64] [--device cpu]

  python -m dpdist_tpu_torch.cli.export_serving \
      --pcrnet_ckpt results/policy_mf_tsn1200clip_dpdist_final --out policy.pt2 \
      --stop_threshold 1e-3 --stop_period 2 --stop_select period0 --early_exit

--device (cuda, or cpu) takes the place of the reference's --platforms: the
program is traced there, and a portable one exported on the CPU serves on
the card (run_serving --device cuda). --native_kernels keeps the Hopper
kernels as dpdist:: ops (a program for the card; the loading process
imports dpdist_tpu_torch.kernels.ops). It prints one JSON line: out, bytes,
the input shapes, device, with_grad and native_kernels.
"""

from __future__ import annotations

import argparse
import json
import os

from dpdist_tpu_torch.cli.common import add_device_arg


def main(argv=None):
    """Run the CLI; returns the printed dict."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--dpdist_ckpt", default=None,
                     help="export the frozen distance from this ckpt")
    src.add_argument("--pcrnet_ckpt", default=None,
                     help="export a registration policy: (template, source) -> (T_pred, "
                          "aligned source)")
    p.add_argument("--out", required=True)
    p.add_argument("--num_point", type=int, default=None,
                   help="points per cloud (default: the checkpoint's)")
    p.add_argument("--batch", type=int, default=None,
                   help="pairs per call; omit for a symbolic batch")
    p.add_argument("--iterations", type=int, default=None,
                   help="pcrnet: refinement iterations (default: the config's "
                        "eval_iterations)")
    p.add_argument("--with_grad", action="store_true",
                   help="dpdist: export (distance, d/d src), the frozen-loss training "
                        "signature")
    p.add_argument("--out_of_grid_penalty", type=float, default=1.0)
    add_device_arg(p)
    p.add_argument("--native_kernels", action="store_true",
                   help="keep the Hopper kernels as dpdist:: ops (a program for the card)")
    p.add_argument("--stop_threshold", type=float, default=None,
                   help="pcrnet: bake the convergence-stopping protocol into the program "
                        "(see eval_registration)")
    p.add_argument("--stop_period", type=int, default=1)
    p.add_argument("--stop_select", default="last", choices=["last", "chamfer", "period0"])
    p.add_argument("--early_exit", action="store_true",
                   help="pcrnet + stop_threshold: return as soon as the whole batch froze "
                        "(fewer iterations, the same outputs)")
    a = p.parse_args(argv)

    from dpdist_tpu_torch import serving

    if a.pcrnet_ckpt:
        from dpdist_tpu_torch.cli.common import load_pcrnet_checkpoint_state

        pcfg, params, state = load_pcrnet_checkpoint_state(a.pcrnet_ckpt)
        ep = serving.export_registration(
            params, pcfg, state=state, num_point=a.num_point, iterations=a.iterations,
            batch=a.batch, portable=not a.native_kernels, device=a.device,
            stop_threshold=a.stop_threshold, stop_period=a.stop_period,
            stop_select=a.stop_select, early_exit=a.early_exit)
    else:
        from dpdist_tpu_torch.train.checkpoint import load_dpdist_checkpoint

        cfg, params, state = load_dpdist_checkpoint(a.dpdist_ckpt)
        ep = serving.export_frozen_distance(
            params, state, cfg, num_point=a.num_point, batch=a.batch,
            with_grad=a.with_grad, out_of_grid_penalty=a.out_of_grid_penalty,
            portable=not a.native_kernels, device=a.device)
    serving.save_exported(ep, a.out)
    batch, num_point = serving.exported_inputs(ep)
    out = {"out": a.out, "bytes": os.path.getsize(a.out),
           "inputs": [[batch if batch is not None else "b", num_point, 3]] * 2,
           "device": a.device, "with_grad": a.with_grad, "native_kernels": a.native_kernels}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
