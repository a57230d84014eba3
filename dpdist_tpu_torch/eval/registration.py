"""Registration evaluation (port of dpdist_tpu/eval/registration.py).

The reference's protocol (results_itrPCRNet_no_stop.py): a fixed number of
refinement iterations (50), per-iteration translation / rotation /
convergence error curves, accuracy buckets at (2.5 deg, 0.05), (5 deg,
0.05), (10 deg, 0.1) and (20 deg, 0.2), and CSV / JSON reports. A whole
batch of cases runs at once: the refinement (models/pcrnet.pcrnet_refine)
and the pose accumulation with its optional convergence stop run on the
device, and each batch's curves come back to the host once.

Errors: the network aligns source -> template while the ground-truth pose
maps template -> source, so the predicted pose is the inverse of the
accumulated transform; rotation error is the geodesic angle in degrees,
translation error the L2 distance.

No Pallas kernel runs here: the policy is dense layers (or the 3dmfv
encoder's convs, with its BN's running statistics from `state`) and 4x4
pose algebra, and the "chamfer" stop's nearest neighbours are the plain
pairwise path at registration's cloud sizes.
"""

from __future__ import annotations

import csv
import inspect
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from dpdist_tpu_torch import resolve_device
from dpdist_tpu_torch.configs import PCRNetConfig
from dpdist_tpu_torch.geometry.se3 import (
    apply_transform,
    compose_transforms,
    convergence_measure,
    invert_transform,
    pose6_to_matrix,
    pose7_to_matrix,
    transform_errors,
)
from dpdist_tpu_torch.geometry.symmetry import FAMILY_SYMMETRY, symmetry_aware_errors
from dpdist_tpu_torch.models.pcrnet import pcrnet_refine
from dpdist_tpu_torch.nn.layers import params_to_device
from dpdist_tpu_torch.ops.chamfer import nn_distance

ACCURACY_BUCKETS = ((2.5, 0.05), (5.0, 0.05), (10.0, 0.1), (20.0, 0.2))


def accuracy_buckets(rot_err_deg: np.ndarray, trans_err: np.ndarray):
    """Fraction of cases within each (rot deg, trans) tolerance pair."""
    out = {}
    for r, t in ACCURACY_BUCKETS:
        ok = (rot_err_deg < r) & (trans_err < t)
        out[f"acc_rot{r}_trans{t}"] = float(np.mean(ok))
    return out


def _percase_chamfer(points, template):
    """(B,) symmetric mean squared chamfer, the "chamfer" stop's metric."""
    d1, _, d2, _ = nn_distance(points, template)
    return (torch.mean(d1, 1) + torch.mean(d2, 1)) / 2.0


def init_stop_carry(dtype, B: int, stop_period: int, source, template, stop_select: str):
    """Initial carry of stopping_step: (T (B, 4, 4), hist (stop_period, B,
    4, 4), the last stop_period transforms with hist[0] the oldest, frozen
    (B,), conv_iter (B,), and the chamfer of the current transform (B,),
    carried so the "chamfer" stop costs one nn_distance an iteration)."""
    if stop_period < 1:
        raise ValueError(f"stop_period must be >= 1, got {stop_period}")
    dev = source.device
    T0 = torch.eye(4, dtype=dtype, device=dev).expand(B, 4, 4)
    sc0 = (_percase_chamfer(source, template) if stop_select == "chamfer"
           else torch.zeros((B,), dtype=dtype, device=dev))
    return (T0, T0.expand((stop_period,) + T0.shape), torch.zeros((B,), dtype=torch.bool,
                                                                  device=dev),
            torch.full((B,), -1, dtype=torch.int32, device=dev), sc0)


def stopping_step(carry, pose7, i, source, template, *, stop_threshold,
                  stop_period: int, stop_select: str):
    """One pose accumulation and freeze step (iteration i, 0-based: a
    Python int, or a 0-dim integer tensor inside a traced loop, for which
    the steps that depend on i are tensor ops with the same results).

    With stop_threshold set, a case freezes once the convergence measure of
    its new transform against the one stop_period iterations back falls
    below the threshold (armed from iteration stop_period - 1); the freeze
    keeps, by stop_select: "last" the new transform; "period0" the most
    recent one whose composition count is a multiple of stop_period (for
    a flip cycle the policy sits in from the start, the converged parity);
    "chamfer" the better aligned of the new and the previous transform by
    per-case chamfer. Returns (new_carry, (T, ce)), ce the period-1
    measure (0 once frozen)."""
    T_prev, hist, frozen, conv_iter, sc_prev = carry
    T_cand = compose_transforms(pose7_to_matrix(pose7), T_prev)
    ce = convergence_measure(T_cand, T_prev)
    sc = sc_prev
    if stop_threshold is not None:
        ce_stop = ce if stop_period == 1 else convergence_measure(T_cand, hist[0])
        newly = (~frozen) & (ce_stop < stop_threshold)
        armed = i >= stop_period - 1   # the period-p check needs p transforms first
        if torch.is_tensor(armed):
            newly = newly & armed
        elif not armed:
            newly = torch.zeros_like(newly)
        pick = T_cand
        if stop_select == "period0":
            # T_cand composes i + 1 poses; hist[p - r] composes i + 1 - r.
            r = (i + 1) % stop_period
            back = (stop_period - r) % stop_period
            if torch.is_tensor(r):
                pick = torch.where(r == 0, T_cand, hist.index_select(0, back.reshape(1))[0])
            else:
                pick = T_cand if r == 0 else hist[back]
        if stop_select == "chamfer":
            sc_cand = _percase_chamfer(apply_transform(source, T_cand), template)
            better_prev = sc_prev < sc_cand
            pick = torch.where(better_prev[:, None, None], T_prev, T_cand)
            sc = torch.where(frozen, sc_prev,
                             torch.where(newly, torch.minimum(sc_prev, sc_cand), sc_cand))
        T = torch.where(frozen[:, None, None], T_prev,
                        torch.where(newly[:, None, None], pick, T_cand))
        fill = i.to(conv_iter.dtype) if torch.is_tensor(i) else i
        conv_iter = conv_iter.masked_fill(newly, fill)
        ce = torch.where(frozen, torch.zeros_like(ce), ce)
        frozen = frozen | newly
    else:
        T = T_cand
    hist = torch.cat([hist[1:], T[None]], dim=0)
    return (T, hist, frozen, conv_iter, sc), (T, ce)


def accumulate_with_stopping(poses, source, template, *, stop_threshold=None,
                             stop_period: int = 1, stop_select: str = "last"):
    """Accumulate per-iteration poses (iterations, B, 7) into transforms,
    with the optional convergence stop (stopping_step). source and template
    (B, N, 3) are read only by stop_select="chamfer".

    Returns (T_final (B, 4, 4), T_curve (iterations, B, 4, 4), ce_curve
    (iterations, B), frozen (B,), conv_iter (B,)). stop_threshold None is
    the reference's no-stop protocol."""
    iterations, B = poses.shape[0], poses.shape[1]
    carry = init_stop_carry(template.dtype, B, stop_period, source, template, stop_select)
    Ts, ces = [], []
    for i in range(iterations):
        carry, (T, ce) = stopping_step(carry, poses[i], i, source, template,
                                       stop_threshold=stop_threshold, stop_period=stop_period,
                                       stop_select=stop_select)
        Ts.append(T)
        ces.append(ce)
    T_final, _, frozen, conv_iter, _ = carry
    return T_final, torch.stack(Ts), torch.stack(ces), frozen, conv_iter


@torch.no_grad()
def _eval_program(params, cfg: PCRNetConfig, template, source, gt_pose6, iterations: int,
                  stop_threshold=None, stop_period: int = 1, stop_select: str = "last",
                  state=None):
    """Per-iteration error curves (iterations, B), all on the device; state
    carries the 3dmfv encoder's BN running statistics (eval mode)."""
    _, _, poses = pcrnet_refine(params, cfg, source, template, iterations=iterations,
                                stop_gradient_iters=False, state=state)
    T_gt = pose6_to_matrix(gt_pose6)
    T_final, T_curve, ce, frozen, conv_iter = accumulate_with_stopping(
        poses, source, template, stop_threshold=stop_threshold, stop_period=stop_period,
        stop_select=stop_select)
    te, re = transform_errors(invert_transform(T_curve), T_gt)
    return T_final, te, re, ce, frozen, conv_iter


def _has_info(dataset) -> bool:
    """Whether dataset.sample_batch takes return_info (probed once, so a
    TypeError raised inside a dataset is never swallowed)."""
    try:
        sig = inspect.signature(dataset.sample_batch)
        return "return_info" in sig.parameters or any(
            p.kind is inspect.Parameter.VAR_KEYWORD for p in sig.parameters.values())
    except (TypeError, ValueError):
        return True


def evaluate_registration(params, cfg: PCRNetConfig, dataset, *, num_cases: int = 64,
                          iterations: Optional[int] = None, batch_size: int = 64,
                          report_dir: Optional[str] = None,
                          stop_threshold: Optional[float] = None, stop_period: int = 1,
                          stop_select: str = "last", state=None, device="cuda"):
    """Run the fixed-iteration protocol and produce the reference's report.

    params, state: the policy's trees (tensors, or numpy arrays as a
    checkpoint holds them); state carries the 3dmfv encoder's BN running
    statistics (None: batch statistics, as the reference falls back). Cases come from dataset.sample_batch in batches of
    batch_size (the dataset's draws depend on it, so a report is
    comparable only at the same batch size; the reference's default is
    64). The ragged tail batch runs as it is.

    Returns a dict: final mean / var errors, accuracy buckets, times on
    this device (time_per_case_s leaves out the first batch), the
    per-iteration mean curves, with stop_threshold converged_frac and
    converge_iter_mean, and with family labels the symmetry-aware errors
    and a per_family slice.
    """
    dev = resolve_device(device)
    iterations = iterations or cfg.eval_iterations
    params = params_to_device(params, dev)
    state = params_to_device(state, dev)
    has_info = _has_info(dataset)

    all_te, all_re, all_ce, all_frozen, all_conv_iter, all_Tf, all_gt = ([] for _ in range(7))
    families: list = []
    batch_times = []
    t0 = time.perf_counter()
    n_done = 0
    while n_done < num_cases:
        b = min(batch_size, num_cases - n_done)
        if has_info:
            template, source, gt, info = dataset.sample_batch(b, return_info=True)
        else:
            template, source, gt = dataset.sample_batch(b)
            info = None
        fams = (info or {}).get("family")
        families.extend(fams if fams is not None else [None] * b)
        tb = time.perf_counter()
        T_final, te, re, ce, frozen, conv_iter = _eval_program(
            params, cfg, *(torch.as_tensor(np.asarray(a, np.float32), device=dev)
                           for a in (template, source, gt)),
            iterations, stop_threshold, stop_period, stop_select, state=state)
        te = te.cpu().numpy()   # the synchronous copy closes the batch's time
        batch_times.append((time.perf_counter() - tb, b))
        all_te.append(te)
        all_re.append(re.cpu().numpy())
        all_ce.append(ce.cpu().numpy())
        all_Tf.append(T_final.cpu().numpy())
        all_frozen.append(frozen.cpu().numpy())
        all_conv_iter.append(conv_iter.cpu().numpy())
        all_gt.append(np.asarray(gt))
        n_done += b
    elapsed = time.perf_counter() - t0
    steady = batch_times[1:] or batch_times
    per_case = sum(t for t, _ in steady) / max(sum(n for _, n in steady), 1)

    te = np.concatenate(all_te, axis=1)   # (iterations, num_cases)
    re = np.concatenate(all_re, axis=1)
    ce = np.concatenate(all_ce, axis=1)
    final_te, final_re = te[-1], re[-1]

    report = {
        "num_cases": int(n_done),
        "iterations": int(iterations),
        "rot_err_mean_deg": float(final_re.mean()),
        "rot_err_var": float(final_re.var()),
        "trans_err_mean": float(final_te.mean()),
        "trans_err_var": float(final_te.var()),
        "time_total_s": elapsed,
        "time_per_case_s": per_case,
        **accuracy_buckets(final_re, final_te),
        "curve_rot_err_mean": re.mean(1).tolist(),
        "curve_trans_err_mean": te.mean(1).tolist(),
        "curve_convergence_mean": ce.mean(1).tolist(),
    }
    if stop_threshold is not None:
        frozen = np.concatenate(all_frozen)
        conv_iter = np.concatenate(all_conv_iter)
        report["stop_threshold"] = float(stop_threshold)
        report["stop_period"] = int(stop_period)
        report["stop_select"] = str(stop_select)
        report["converged_frac"] = float(frozen.mean())
        if frozen.any():
            report["converge_iter_mean"] = float(conv_iter[frozen].mean())

    if any(f is not None for f in families):
        # Symmetry-aware rotation error (geometry/symmetry.py): scored
        # against the ground truth's whole coset for rotationally symmetric
        # families; for trivial families it is the device's final_re.
        Tf = np.concatenate(all_Tf)
        gts = np.concatenate(all_gt)
        R_pred = np.swapaxes(Tf[:, :3, :3], -1, -2)
        R_gt = pose6_to_matrix(torch.as_tensor(gts, dtype=torch.float32)).numpy()[:, :3, :3]
        sym_re = symmetry_aware_errors(R_pred, R_gt, families)
        trivial = np.asarray([FAMILY_SYMMETRY.get(f or "") is None for f in families])
        sym_re = np.where(trivial, final_re, sym_re)
        report["sym_rot_err_mean_deg"] = float(sym_re.mean())
        report["sym_acc"] = {k.replace("acc_", "sym_acc_"): v
                             for k, v in accuracy_buckets(sym_re, final_te).items()}
        fam_arr = np.asarray([f or "unknown" for f in families])
        per_family = {}
        for fam in sorted(set(fam_arr)):
            m = fam_arr == fam
            per_family[fam] = {
                "num_cases": int(m.sum()),
                "rot_err_mean_deg": float(final_re[m].mean()),
                "trans_err_mean": float(final_te[m].mean()),
                **accuracy_buckets(final_re[m], final_te[m]),
                "sym_rot_err_mean_deg": float(sym_re[m].mean()),
                **{k.replace("acc_", "sym_acc_"): v
                   for k, v in accuracy_buckets(sym_re[m], final_te[m]).items()},
            }
        report["per_family"] = per_family

    if report_dir:
        _write_reports(report_dir, report, te, re, ce, final_re, final_te, iterations)
    return report


def _write_reports(report_dir, report, te, re, ce, final_re, final_te, iterations):
    """registration_report.json, per_case_errors.csv, iteration_curves.csv,
    log_data.h5 (the raw (iterations, cases) curves, where h5py imports)
    and the two plots (where matplotlib imports)."""
    os.makedirs(report_dir, exist_ok=True)
    with open(os.path.join(report_dir, "registration_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    with open(os.path.join(report_dir, "per_case_errors.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["case", "rot_err_deg", "trans_err"])
        for i, (r, t) in enumerate(zip(final_re, final_te)):
            w.writerow([i, float(r), float(t)])
    with open(os.path.join(report_dir, "iteration_curves.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["iteration", "rot_err_mean_deg", "trans_err_mean", "convergence_mean"])
        for i in range(iterations):
            w.writerow([i, float(re[i].mean()), float(te[i].mean()), float(ce[i].mean())])
    try:
        import h5py

        with h5py.File(os.path.join(report_dir, "log_data.h5"), "w") as hf:
            hf.create_dataset("TE", data=te)
            hf.create_dataset("RE", data=re)
            hf.create_dataset("CE", data=ce)
    except ImportError:
        pass
    from dpdist_tpu_torch.eval.viz import save_error_histograms, save_iteration_curves

    save_iteration_curves(os.path.join(report_dir, "iteration_curves.png"),
                          report["curve_rot_err_mean"], report["curve_trans_err_mean"],
                          report["curve_convergence_mean"])
    save_error_histograms(os.path.join(report_dir, "error_histograms.png"), final_re, final_te)
