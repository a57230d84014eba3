#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths through their hand-written kernels and checks
them: the frozen DPDist distance served from the committed nets (fused
kernel at 64 points; streaming 3DmFV encode and patch-only gather at 256),
served in bfloat16 (the fused gather + decoder kernel, fused_gather="full";
the composed bf16 path, "auto") and through the per-query gather
(fused_gather="on"), the frozen loss with its source gradient (table-gather
kernels and the adjoint; "on"; in bfloat16 with the bf16 adjoint), DPDist
training (table-gather kernel; in float32 and bfloat16), eval_pair on two
10,000-point clouds (encode, patch-only gather and the NN-min kernel), and
the training CLIs: gen_data's ground truth on the card (the NN-min kernel)
and train_dpdist on it; the rest of the DPDist model family (BN and
conv_version=3 decoders, the 7-channel encode, the global k=0 embedding,
the pointnet encoder, 2-D) at full width, and dense evaluation (a 64^3
distance field); and registration: the production PCRNet policy
evaluated on the committed 5,070 poses with the period0 stop (no kernel),
and PCRNet trained on the frozen DPDist loss (table-gather kernel and
adjoint), by the trainer and by the train_pcrnet and eval_registration
CLIs; and the autoencoder trained on the frozen DPDist loss at full width
(table-gather kernel and adjoint), by the trainer and the train_aue CLI,
compare_losses (the fused kernel), the blocked EMD and the 3dmfv PCRNet
encoder; and the serving export: the frozen distance and the production
policy as torch.export programs, portable (plain ops) and native (the
kernels as torch.library ops), saved, loaded onto the card and served,
and the export_serving and run_serving CLIs; the 3dmfv registration policy
at full width as programs (row 7 inside the refinement loop); and float16,
the third dtype of the reference's API: rows 1, 2, 6 and 3 in float16, the
fp16 distance served, the fp16 frozen loss's gradient, fp16 training and an
fp16 native program.

  1. device        the card's name and power limit; fails without CUDA;
                   TF32 and cuBLAS's bf16 and fp16 reduced-precision
                   reductions off.
  2. build         compiles dpdist_tpu_torch/csrc (one nvcc per source,
                   all started together, and one link) and, beside it, the
                   native host library (g++, dpdist_tpu_torch/native).
  3. kernel        the fused 3DmFV + patch-gather kernel against its plain
                   PyTorch version at 2B = 512 clouds, M = N = 64, with
                   off-grid queries and points on cell edges (x within
                   2e-5, vox exact).
  4. table_kernels the table-gather kernel and its adjoint against their
                   plain versions at B = 256, N = 64, with off-grid and
                   cell-edge queries carrying gradient (x and vox exact;
                   dfv within 1e-6 of its largest entry, the same from run
                   to run, and equal bit for bit to the ordered plain sum,
                   one index_add_ per query in query order), and the fused
                   kernel's backward against autograd through the plain
                   composition.
  5. encode_kernel the streaming 3DmFV encode against the plain encode at
                   B = 256, N = 256 (one pass per cloud that finalises);
                   B = 4, N = 1,000 and B = 1, N = 10,000 (each cloud split
                   over blocks, then merged), with points on cell edges and
                   a few far outside the grid (within 2e-5); its backward
                   (the plain encode's replay) against autograd through the
                   plain encode at B = 16, N = 256.
  6. gather6_kernel the patch-only table gather against its plain version
                   at B = 256, N = 256 with off-grid queries (exact).
  6b. fault5       ROADMAP.md §3's fault 5: the patch-only gather (row 6) at
                   B = 2, N = 128^3 = 2,097,152 (16,384 runs of 128 rows a
                   cloud; 65,536 tiles of 32 queries under the old grid,
                   past its 65,535 y-blocks) on a g = 2, k = 1, C = 1
                   window, float32 and bfloat16, exact; the adjoint (row 3)
                   at N = 860,000, past its old 32-bit cloud offsets, on
                   integer grads, exact; row 6's time at B = 256, N = 256.
  7. chamfer_kernel the NN-min kernel against its plain version at B = 1,
                   N = M = 10,000, B = 2, N = 1,000, M = 4,099, N = 1,
                   M = 1, M below one float4 group, N and M one past a tile
                   and a chunk, B = 3 at N = 10,000, coordinates x100, and
                   points duplicated (d = 0 exactly) (within 1e-6 +
                   1e-5 |d|; over 5 calls torch.profiler sees
                   nn_min_kernel and no other kernel, at most once a call;
                   two calls equal bit for bit), and chamfer_distance on the
                   card at 10,000 x 10,000 against the plain path (within
                   1e-5).
  8. serving       per committed net: three requests of B = 256 synthetic
                   pairs through load_frozen_distance (launch counters
                   reset before and read after), outputs finite and in
                   [0, 2], the kernel path against the plain path
                   (fused_gather="off") within 1e-4, and the golden pairs
                   against the JAX values within 1e-4.
  9. serving_large the same at np = 256 (2 encode and 2 patch-only gather
                   launches per request, none of the others), with the
                   golden np = 256 pairs.
 10. frozen_grad   per committed net: the frozen loss and its gradient in
                   pcA on the golden pairs against the JAX values; three
                   source-gradient calls at B = 256 (counters reset before,
                   read after: 2 table-gather and 1 adjoint launch per
                   call), against the plain path and the fused-kernel
                   path; the parameters unchanged and without .grad.
 11. frozen_grad_large the same at np = 256: per call 2 encode, 2
                   patch-only gather and 1 adjoint launch, and one encode
                   replay (pcA's; none for pcB); against the plain path
                   and the golden np = 256 values.
 12. train         DPDistTrainer at the canonical config, B = 16: 30 steps
                   on one synthetic batch whose labels are distances to a
                   10k-point surface (counters reset before, read after:
                   one table-gather launch per step, no adjoint, one Adam
                   launch per step); the loss falls; one step on the kernel path against the plain
                   path; save -> restore gives equal params.
 13. eval_pair_large cli.eval_pair.main in-process on two 10,000-point
                   synthetic surfaces written as csv (counters: 2 encode,
                   2 patch-only gather, 2 NN-min launches); each key
                   against the port's plain path on the same clouds; the
                   golden np = 256 pairs' chamfer and EMD on the card.
 14. fused_forward_kernel the fused gather + decoder kernel against its
                   plain version on the first np = 64 request (2B = 512
                   clouds, the committed net's decoder in bf16) with 5 % of
                   the queries pushed off the grid, and on the first
                   np = 256 request (within 2e-2 on pre-activation outputs,
                   all finite); both against the same rounding points with
                   float64 sums, printed.
 15. gather_fused_kernel the per-query gather against its plain version on
                   the first np = 64 request's pcA volumes and pcB queries,
                   partly off the grid (exact), and its backward (the
                   adjoint kernel on the masked gradient) against autograd
                   through the plain version (within 1e-6 of its largest
                   entry).
 16. bf16_kernels  the bf16 outputs of the fused mfv kernel, the table
                   gather and the patch-only gather against their float32
                   outputs rounded (within one bf16 ulp; equal expected).
 17. serving_bf16  per committed net, "full" and "auto" in bf16 at np = 64
                   and np = 256: three requests of B = 256 (counters: "full"
                   1 fused forward per request, plus 2 encodes at 256;
                   "auto" 1 fused mfv at 64, 2 encodes and 2 patch-only
                   gathers at 256); the golden pairs against the JAX bf16
                   values within 2e-3 and the float32 ones within 0.03;
                   "full" against "auto" within 2e-3; off-grid queries
                   exactly 0.
 18. serving_on    per committed net, "on" in float32 at np = 64 and 256
                   (counters: 2 per-query gathers per request, plus 2
                   encodes at 256); against the plain path and the golden
                   pairs within 1e-4.
 19. frozen_grad_on the frozen loss with "on" at np = 64 and 256 as in
                   frozen_grad: per call 2 per-query gathers and 1 adjoint
                   launch (plus 2 encodes and one replay at 256); d/dpcA
                   against the table path's by the per-point criterion.
 17b. bf16_adjoint_kernel the adjoint on a bf16 grad at B = 256, N = 64
                   (strided) and N = 256 (contiguous), off-grid and
                   cell-edge queries: a bf16 dfv equal bit for bit to the
                   ordered plain sum rounded, the same from run to run, and
                   within one bf16 ulp of float64 sums.
 17c. fp16_kernels rows 1, 2 and 6 with a float16 output at the main path's
                   shapes, equal to their float32 outputs rounded once;
                   rows 2 and 6 on a volume of float16's edge values (65,504,
                   ties, past it to inf, the subnormals and their ties; 32
                   clouds) bit for bit numpy's rounding of the float32 rows
                   on the host;
                   row 3 on fp16 grads at B = 256, N = 64 (strided) and 256
                   (contiguous): equal to the ordered float32 sum rounded
                   once, the same from run to run over 10 calls, within one
                   fp16 ulp of float64 sums beyond the float32 sums' own
                   distance from them (a sum that cancels to near 0 can
                   leave float32's rounding above fp16's finest steps), and
                   on sums past 65,504 (inf) and in the subnormals. Their times are taken in `times`.
 20. route_limits  configs past the fused kernels' limits, served from the
                   first np = 64 request (counters reset before, read
                   after): the committed decoder at embedding_size=1000
                   (past the mfv kernel's 992 Gaussians) in f32 and bf16
                   "auto" (2 table-gather launches) and bf16 "full" (1 fused
                   forward), and a random bf16 "full" net with hidden widths
                   40 (2 table-gather launches); each against the plain
                   path (1e-4; bf16 2e-3). A ValueError fails the phase.
 20b. frozen_grad_bf16 per committed net in bfloat16 at np = 64 and 256:
                   the frozen loss and d/dpcA on the golden pairs against
                   the golden bf16_grad values (JAX bf16), three
                   source-gradient calls of B = 256 (counters: np = 64 2
                   table-gather and 1 bf16 adjoint launch a call; np = 256
                   2 encodes, 2 patch-only gathers, 1 bf16 adjoint and one
                   replay), against the port's plain bf16 path (loss within
                   2e-3; d/dpcA within 1e-2 of its largest entry on 95 % of
                   the points, 5e-2 on all, cosine >= 0.999); "mfv" and
                   "on" once each at np = 64; "full" refused.
 20c. train_bf16   30 bf16 trainer steps at B = 16 (float32 master weights;
                   one table-gather launch a step); the loss falls; one step
                   against the plain bf16 path; a torch.profiler trace of a
                   step (train/profiling.trace) with its top kernels.
 20c2. serving_fp16 per committed net in float16: "auto" at np = 64 (1
                   row-1 launch a request) and 256 (2 row-7, 2 row-6),
                   "full" at 64 (the table path in float16: 2 row-2) and
                   "on" at 64 (2 row-10); three requests of B = 256 each,
                   counted, against the port's plain fp16 path; the golden
                   pairs against the JAX fp16 values within TOL_FP16 and
                   the float32 ones within TOL_FP16_VS_F32; off-grid
                   queries exactly 0.
 20c3. frozen_grad_fp16 as frozen_grad_bf16 in float16 against the golden
                   fp16_grad values (loss within TOL_FP16): 2 row-2 and 1
                   row-3 fp16 launch a call at np = 64, 2 row-7, 2 row-6,
                   1 row-3 fp16 and one replay at 256; "full" computes
                   (the table path) instead of being refused.
 20c4. train_fp16  30 fp16 trainer steps at B = 16 (float32 master weights,
                   no loss scaling, as the reference's; one row-2 launch a
                   step); the loss falls; one step against the plain fp16
                   path.
 20d. gtgen_kernel the NN-min kernel as the ground-truth generator runs it
                   (50,000 candidates x a 10,000-point surface, then a sqrt)
                   against the native host library, and one model generated
                   on the card against the CPU (row counts, the share of
                   equal rows, every card row's distance vs the native one,
                   every card row inside the selection rule by its native
                   distance, and the first point where the two sets part
                   a threshold flip).
 20e. train_cli    gen_data --device cuda (6 models at full size; NN-min
                   launches only), train_dpdist for 2 epochs in float32 and
                   in bfloat16 (counters: 1 table-gather launch a step, 1
                   fused mfv launch an eval), --resume, and the checkpoint
                   served by load_frozen_distance; the native library built
                   on this host.
 20f. registration_eval the production policy
                   (results/policy_mf_tsn1200clip_dpdist_final) on all 5,070
                   committed poses, 50 iterations, the period0 stop (threshold
                   1e-3, period 2), the production protocol's data (5
                   families, 125 templates, sparse split, seed 777, batches
                   of 64): every accuracy bucket, plain and symmetry-aware,
                   overall and per family, and converged_frac within 1 point
                   of the golden JAX report (golden_registration.json); the
                   first 256 cases per case at 8 iterations against JAX's
                   (rotation within 0.05 deg and translation within 1e-5 on
                   99 % of them, every case within 2 deg and 1e-3), and at 50
                   printed; no kernel launched (counters); cases/s at batches
                   of 64 and of 1,014; the buckets printed beside the archived
                   TPU run's (of the recipe's best checkpoint), as
                   information.
 20g. train_pcrnet the production recipe (B = 16, full BPTT over 8 loops,
                   grad_clip 1.0, noise, the dpdist loss on the second
                   committed net): the first step resumed from the policy
                   against the golden JAX loss (within 1e-4 relative; the
                   gradient norm printed); 30 steps from scratch on one batch,
                   each launching exactly 2 table-gather and 1 adjoint
                   (counters reset before and read after each step), the loss
                   falling; one step's loss and gradients against the plain
                   path (fused_gather="off"; 1e-5 relative, 1e-4 of each
                   leaf's largest entry); the step's time; the
                   train_pcrnet CLI for 1 epoch of 4 batches resumed from the
                   policy (8 table-gather and 4 adjoint launches), then
                   eval_registration on its checkpoint (256 cases, 8
                   iterations, no launch).
 20h. aue         the production AUE (3dmfv, 512 Gaussians, np 64, BN; its
                   402.7 M-weight decoder layer) and the pn AUE at B = 16,
                   from the seeded weights of the golden file
                   (dpdist_tpu_torch/assets/golden_aue.json, JAX on the CPU),
                   rebuilt here and checked by their per-leaf sums: the
                   reconstruction of 4 golden clouds (1e-4), the monitor and
                   3 Adam steps per opt_type against JAX's (see
                   TOL_LATER_STEPS), each "ours" step launching exactly 2
                   table-gather and 1 adjoint (counters reset before and read
                   after each step; a chamfer step none) and every step
                   exactly 1 fused Adam launch; the step's loss and
                   d/d reconstruction on the kernel path against the plain
                   path; the step's ms and peak memory.
 20i. train_aue_cli gen_data on the card, train_aue for the 3dmfv AUE
                   ("ours") and the pn AUE (chamfer), 1 epoch each with its
                   eval (exact launch counts), and --resume.
 20j. compare_losses the CLI at its defaults on the canonical net against the
                   golden JAX report (DPDist 1e-4, chamfer and EMD 1e-5);
                   160 fused mfv launches, one a scored pair.
 20k. emd_blocked  the blocked Sinkhorn EMD against the port's CPU run and,
                   at eval_pair's 10,000-point clouds, against the dense plan;
                   timed.
 20l. pcrnet_3dmfv the 3dmfv PCRNet encoder's golden step (the frozen DPDist
                   loss, B = 8): loss, gradient norm, BN state and the eval
                   refinement after it against JAX's; 2 table-gather and 1
                   adjoint launch; the step's ms.
 21. times         CUDA-event medians of 20 runs after warm-up: each kernel
                   with its bound, its plain version and a PyTorch library
                   call computing the same function where there is one
                   (rows 2 and 3 on the first request's pcB, the queries
                   the frozen loss gives them; row 6 on the np = 256
                   request's pcB; row 8 on eval_pair's clouds); the encode
                   kernel against the plain encode at B = 256, N = 64 and
                   256, and at B = 1, N = 10,000; row 9 at np = 256 and its
                   TFLOP/s at both sizes; the cuBLAS bf16 decoder with the
                   first layer's K padded to the pack's (a yardstick the
                   port never runs), and the cuBLAS fp16 decoder on the
                   same rows, unpadded and padded; the device time of each CUDA kernel
                   that rows 9 and 7 launch (torch.profiler); rows 2 and
                   6 (each also with its bf16 output, bound and index_select
                   on the bf16 volume) and 3 with their device times
                   (torch.profiler) and % of bound on both times, as rows 1
                   (also with its bf16 output and at M = N = 128, checked
                   against its plain version there), 10 and 8 have
                   theirs, row 8 also with the issue-slot floor of its
                   per-dimension form at the card's top SM clock and at
                   B = 2, N = 1,000, M = 4,099 and B = 256, N = M = 64;
                   row 3
                   at N = 256 on the np = 256 frozen loss's inputs (the
                   patch part of row 6's gradient) with its bound,
                   index_add_, the ordered plain sum (bit for bit) and
                   float64 sums (within 1e-6 of the largest entry); the
                   forward, the frozen source-gradient step and the train
                   step at B = 256, np = 64, and the forward and the
                   source-gradient step at np = 256; the bf16 forwards
                   ("full", "auto") and the "on" forward at np = 64 and
                   256; eval_pair at 10,000 points, end to end and per key;
                   the fused Adam kernel on the production AUE's 24 leaves
                   (407.8 M weights) against the list path
                   (train/optim.adam_leaf_plain) on the same inputs, p, mu
                   and nu bit for bit in one launch, then timed with its
                   byte bound (28 B a weight), the list path and its
                   device time;
                   the adjoint's bf16 variant (bound, index_add_ in bf16)
                   at N = 64 and 256; the fp16 outputs of rows 1, 2 and 6
                   (index_select on the fp16 volume) and row 3 on an fp16
                   grad at N = 64 and 256 (index_add_ in fp16, its SASS
                   loop and issue-slot floor), the records' "fp16" entries
                   and table_gather_bwd_fp16; the NN-min kernel at the generator's
                   50,000 x 10,000; the bf16 and fp16 source-gradient steps
                   at np = 64 and 256, the bf16 train step at B = 16 and
                   256 and the fp16 one at 256, the fp16 "auto" forwards;
                   last,
                   rows 2 and 3's share of the production PCRNet train step's
                   device time over 5 steps (torch.profiler), then the same
                   for the production AUE step, with its idle share.

 22. c7_kernels    rows 2, 3, 6, 10 and 9 on 7-channel volumes (the
                   full_fv=False encode) at B = 256, N = 64 (row 6 at 256;
                   row 9 over the 2B stack) against their plain versions:
                   copies exact, row 3 equal to the ordered plain sum, row 9
                   within 2e-2.
 23. variants      the DPDist model family at full width from the seeded
                   weights of dpdist_tpu_torch/assets/golden_variants.json
                   (JAX on the CPU), rebuilt here and checked by their
                   per-leaf sums: use_bn=True, conv_version=3,
                   full_fv=False, k=0, the pointnet encoder (k=0, BN) and
                   dims=2 (16 x 16 Gaussians). Per variant the golden
                   forward at B = 4 (f32 within 1e-4, bf16 within 2e-3,
                   "full" for full_fv=False: row 9 at C = 7; fp16 within
                   TOL_FP16); forwards at
                   B = 256 against the plain path, with their launches and
                   times (rows 1 and 2 under BN and conv_version=3; rows 2,
                   6, 10 and bf16 9 at C = 7; row 7 for k=0 at np = 256);
                   the frozen loss's source gradient where a kernel runs
                   (per-point criterion); 3 DPDistTrainer steps at B = 16
                   for BN, conv_version=3 and pointnet against the golden
                   steps in float32 (TOL_VARIANT_STEPS) and in float16
                   (TOL_VARIANT_STEPS_FP16), 2 row-2 launches a BN step, 1
                   a conv_version=3 step, none a pointnet step.
 24. dense         distance_field at 64^3 = 262,144 queries on
                   results/ckpt_best for a 1,024-point surface: the
                   pretransformed path and the row-6 gather path (one row-7
                   encode each) within 1e-5 of each other and 1e-4 of the
                   golden subsample; timed.
                   These three run after times (see there); their launches
                   join the kernels' record.
 25. serving_export the frozen distance of results/ckpt_best as
                   torch.export programs with a symbolic batch, exported on
                   the CPU by three background processes started after build
                   (`chip_smoke.py --export-artifacts DIR PART`; export times
                   printed), saved and loaded onto the card: portable f32,
                   bf16 and with_grad (no launch), native f32 (1 row-1
                   launch a request), bf16 "full" (1 row 9), with_grad
                   (2 row 2, 1 row 3), "on" (2 row 10), f32 at np = 256
                   (2 row 7, 2 row 6) and fp16 (1 row 1 in float16); three
                   requests of B = 256 at np = 64 (256) each, counted,
                   against the eager model (TOL_DIST; bf16 TOL_BF16; fp16
                   TOL_FP16; d/dsrc by the per-point criterion); each served
                   at B = 1 and 64, timed.
 26. serving_registration the production policy under its protocol (50
                   iterations, the period0 stop) as programs, fixed-length
                   and early exit: equal to each other bit for bit at B = 64
                   and 1, against the eager pcrnet_refine +
                   accumulate_with_stopping (TOL_POLICY), no launch, timed
                   at B = 1 and 64; then export_serving (in a background
                   process, a static batch of 8) -> run_serving --synthetic
                   chair --bench 20 on the card.
 26b. serving_registration_3dmfv the 3dmfv policy at full width
                   (PCRNetConfig(encoder="3dmfv"): num_point 1024, an 8^3
                   grid, sigma 0.25, out_features 1024, head (1024, 512,
                   256)) from seeded weights and a BN state off its init
                   (policy3), under the production protocol (50
                   iterations, the period0 stop). Row 7 on this path's
                   clouds (B = 64 and 1, N = 1024) against the plain
                   encode (TOL_X), both timed. Three programs exported in
                   two more background processes: native (row 7's op inside
                   the loop) fixed-length and early exit, portable
                   fixed-length; at B = 64 and 1: native early exit equal
                   to fixed-length bit for bit; each against the eager
                   pcrnet_refine + accumulate_with_stopping at the same
                   batch on the program's route (native: row 7; portable:
                   the plain encode) within TOL_POLICY, with T_pred's
                   spread over the batch printed and required above it;
                   row-7 launches exact (1 for the hoisted template + 1 a
                   trip, none portable); timed at B = 1 and 64 after the
                   checked calls; then a 3dmfv checkpoint with its state
                   through export_serving --native_kernels (background) ->
                   run_serving --synthetic chair (one call) on the card,
                   T_pred finite.
 27. data_parallel the port's parallelism (dpdist_tpu_torch/parallel). At
                   world size 1 on NCCL (initialize_distributed with a file
                   store): the canonical DPDist train step at B = 256 f32
                   on the world's 1 x 1 mesh (no collective) equal bit for
                   bit to the step with no mesh, the two timed in turns;
                   the step's all_reduce of its flat loss-and-gradient
                   buffer, exact over one rank, timed alone; the
                   production PCRNet step on the frozen loss on the 1 x 1
                   mesh against the step with no mesh; a 64^3 field on
                   results/ckpt_best (pretransform "off") on the world's
                   mesh; launches of rows 2, 3, 6 and 7 by name. Then two
                   processes on the one card over gloo (NCCL refuses two
                   ranks on one GPU; `chip_smoke.py --dp-worker RANK DIR`,
                   started at the phase's start): the canonical step at
                   B = DP_LOCAL_BATCH a process, its loss and params against
                   the single-process step on the whole batch, both
                   processes' params equal bit for bit, timed; and the 64^3
                   field sharded over the points axis, gathered on both,
                   against the unsharded field; their launches join the
                   record. Multi-GPU NCCL is not exercised on one card.

Every phase prints a start and an end line. A wall-clock guard ends the
run with a non-zero exit naming the phase. The last lines are the
kernels' JSON record, the nvidia-smi line, and the result line
{"ok": true, "device": {...}}, printed only when every phase passed.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TIME_LIMIT_S = 420
NETS = ("results/ckpt_best", "results/dpdist_multi_r4_ckpt_best")
B_SERVE = 256            # pairs per request
REQUESTS = 3
B_KERNEL = 2 * B_SERVE   # the 2B stacked clouds one forward hands the fused kernel
NP = 64                  # points per cloud (the committed nets' num_point)
G, GRID, K, SIGMA, C = 512, 8, 5, 0.125, 20
TOL_X = 2e-5             # fused kernel vs plain: the encode sums in another order
# Adjoint vs plain, relative to the largest |dfv|: the sums run in another
# order, and their rounding grows with their size (cell 0 collects every
# off-grid query). On the H100 the error read 2.7e-7 of the largest entry
# at B = 256, N = 64 (7.63e-6 of 28.6) and at N = 200 (1.14e-5 of 42.6).
REL_BWD = 1e-6
TOL_DIST = 1e-4          # distances and losses: kernel path vs plain path and vs JAX
# Input gradients, per point relative to the largest entry: within
# REL_GRAD on all but OUTLIERS of the points and within REL_GRAD_FEW on
# every point. The encode's signed sqrt magnifies rounding differences on
# a few points (tests/test_torch_losses_optim.py says why).
REL_GRAD, REL_GRAD_FEW, OUTLIERS = 1e-3, 5e-2, 0.05
B_TRAIN, TRAIN_STEPS, SURFACE_POINTS = 16, 30, 10000
NP_LARGE = 256           # the JAX bench's second forward size (bench.py:133-138)
EVAL_POINTS = 10000      # eval_pair's clouds, dense enough for the NN-min kernel
FAR = 4.5                # far outside the grid: Q underflows to 0 there
# NN-min kernel vs plain: the kernel sums the per-dimension squares with
# FMAs, so the last bits may differ.
TOL_NN_ABS, TOL_NN_REL = 1e-6, 1e-5
# The NN-min kernel's checks: (B, N, M, coordinate scale, points of a
# duplicated in p): eval_pair's clouds, N = 1, M = 1, M below one float4
# group of p, N and M one past a tile of a and a chunk of p, B = 3 at
# N = 10,000, coordinates x100, and d = 0 exactly.
NN_PROFILED_CALLS = 5
NN_SHAPES = ((1, EVAL_POINTS, EVAL_POINTS, 1, False), (2, 1000, 4099, 1, False),
             (1, 1, 777, 1, False), (2, 500, 1, 1, False), (2, 3000, 3, 1, False),
             (2, 1025, 1025, 1, False), (3, EVAL_POINTS, 2000, 1, False),
             (1, 4000, 3000, 100.0, False), (2, 2000, 2500, 1, True))
# chamfer and EMD on the card against the plain path: both sides sum in
# float32 (tests/test_torch_chamfer_emd.py's tolerance against JAX).
TOL_CHAMFER = TOL_EMD = 1e-5
# Float32 operations per (point, Gaussian) pair of the encode: the logit
# (3 subtractions, 3 divisions, 3 products, 3 additions), the softmax's
# exp, division and sum, and the 20 pools (d_pi 4, d_mu 12, d_sigma 18).
ENCODE_OPS_PER_PAIR = 50
NN_OPS_PER_PAIR = 9      # 3 subtractions, 3 products, 2 additions, 1 minimum
# Its issue slots: 3 FADD, 1 FMUL, 2 FFMA and 1 FMNMX a pair, a warp
# instruction covering 32 pairs, one a clock on each of an SM's 4
# schedulers.
NN_INSTRUCTIONS_PER_PAIR = 7
TIMED_RUNS = 20
# H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit): device
# memory rate, float32 outside the tensor cores, and bf16 on the tensor
# cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
# Fused gather + decoder kernel vs its plain version, on pre-activation
# outputs: both sum exact bf16 products in float32, in other orders (the
# tensor cores' float32 accumulation does not round to nearest at each
# add), and a hidden activation at a bf16 rounding edge may round the other
# way. On the H100, against the same rounding points with float64 sums,
# the plain version strayed by up to 8.7e-3 and the kernel by up to 9.8e-3
# on off-grid rows, where |y| reaches 31 (in-grid rows: 2.8e-3 and
# 3.7e-3); the phase prints both each run.
TOL_FF = 2e-2
# Row 9 at C = 7 (c7_kernels) runs on random volumes N(0, C7_VOLUME_SD) and
# a random canonical decoder at xavier scale (in + out fans; on the CPU
# their outputs spread over ~5, 250 times TOL_FF).
C7_VOLUME_SD, C7_WIDTHS = 2.0, (1024, 1024, 1024, 3)
# bf16 served distances against the JAX golden bf16 values and "full"
# against the composed bf16 path: the JAX package's own bound between its
# two bf16 paths (tests/test_kernels.py:146-166); against float32: its
# bf16-vs-f32 tolerance (tests/test_dpdist_model.py:37-56).
TOL_BF16, TOL_BF16_VS_F32 = 2e-3, 0.03
# The DPDist variants' golden train steps (golden_variants.json, JAX on the
# CPU, Adam at lr 1e-4, B = 16): the first step's loss within 1e-4 relative
# and its gradient norm within 1e-3, the later losses within 5e-3 relative,
# the BN state (relative to the larger of 1 and a leaf's largest entry)
# within 4e-6 after the first step and 5e-3 after the last: between the
# port's own spread and what a known fault moves (Adam's lr * sign(g) on
# rounding-sized gradients parts the later steps; the readings, by
# scripts/torch_variant_train_spread.py, are in
# tests/test_torch_variants.py::TOL_STEPS).
TOL_VARIANT_STEPS = (1e-4, 5e-3, 1e-3, 4e-6, 5e-3)
# The same steps in float16 against the golden file's float16 ones
# (tests/test_torch_variants.py::TOL_STEPS_FP16).
TOL_VARIANT_STEPS_FP16 = (1e-3, 2e-2, 1e-2, 5e-4, 1e-1)
# The variants' golden forwards run on informative weights
# (data.golden.informative_weights): their outputs must spread over at
# least VARIANT_MIN_SPREAD times TOL_BF16 (tests/test_torch_variants.py's
# GOLDEN_MIN_SPREAD).
VARIANT_MIN_SPREAD = 50
OFF_GRID_SHARE = 0.05    # queries pushed off the grid in the kernel checks
# The bf16 gradient paths: the frozen loss against the golden bf16_grad
# values (JAX bf16 on the CPU) and against the port's plain bf16 path on the
# card, by the criterion of tests/test_torch_bf16_grad.py: the loss within
# TOL_BF16_LOSS; d/dpcA within REL_BF16 of its largest entry on all but
# OUTLIERS_BF16 of the points, within REL_BF16_FEW on every point, and a
# cosine of at least MIN_COS_BF16.
TOL_BF16_LOSS, REL_BF16, OUTLIERS_BF16, REL_BF16_FEW, MIN_COS_BF16 = 2e-3, 1e-2, 0.05, 5e-2, 0.999
# float16: the served distances and the frozen loss against the golden fp16
# and fp16_grad values (JAX fp16 on the CPU) and against the port's plain
# fp16 path within TOL_FP16, the golden distances against float32 within
# TOL_FP16_VS_F32 (tests/test_torch_dpdist.py's bounds, 8x tighter than
# bf16's); d/dpcA by the bf16 criterion above.
TOL_FP16, TOL_FP16_VS_F32 = 2.5e-4, 4e-3
# The ground-truth generator's size (data/gtgen.py): one round of 50,000
# candidates against a 10,000-point surface, and the files of train_cli's
# dataset at full size (n_surface 10,000, 10^4 near and far points).
GT_CANDIDATES, GT_SURFACE, GT_NEG = 50000, 10000, 10 ** 4
GT_EPS, GT_MIN_EPS = 0.05, 0.001     # gtgen.generate_gt_for_points' defaults
GT_TRAIN, GT_TEST, CLI_BATCH = 4, 2, 2
# Registration: the production policy under the production protocol
# (scripts/chain_r5e.sh's MF arguments, the period0 stop, the evaluator's
# batches of 64), held against the JAX package's golden values.
POLICY = "results/policy_mf_tsn1200clip_dpdist_final"
REG_GOLDEN = "dpdist_tpu_torch/assets/golden_registration.json"
REG_FAMILIES = ("chair", "sphere", "box", "cylinder", "torus")
REG_MF = dict(n_templates=125, families=REG_FAMILIES, sparse=1, s_rand_points=1.0,
              centroid_sub=False, seed=777)
REG_STOP = dict(stop_threshold=1e-3, stop_period=2, stop_select="period0")
REG_CASES, REG_ITERATIONS, REG_BATCH, REG_PER_CASE = 5070, 50, 64, 256
# Every accuracy bucket, overall and per family, within 1 point of JAX's.
# On the CPU the port and JAX part on 16 of the 5,070 cases' buckets at 50
# iterations with the stop (0.3 points; scripts/torch_registration_spread.py).
TOL_BUCKET = 0.01
# The first 256 cases at 8 iterations, per case: rotation within TOL_ROT
# and translation within TOL_TRANS on all but OUTLIERS of them, every case
# within TOL_ROT_FEW / TOL_TRANS_FEW (tests/test_torch_registration.py; on
# the CPU over all 5,070 cases the worst case parted by 1.10 deg and 1.3e-4,
# 4 cases by more than 0.1 deg).
TOL_ROT, TOL_TRANS, OUTLIERS, TOL_ROT_FEW, TOL_TRANS_FEW = 0.05, 1e-5, 0.01, 2.0, 1e-3
# The production recipe's train step (scripts/chain_r5e.sh's MF1200 with
# --loss_type dpdist): B = 16, full BPTT over 8 loops, grad_clip 1.0,
# noise_prob 1.0, dataset seed 0; the first step resumed from the policy
# against the golden JAX loss within TOL_PCR_LOSS (relative).
REG_RECIPE = dict(n_templates=125, families=REG_FAMILIES, sparse=1, s_rand_points=1.0,
                  centroid_sub=False, seed=0, max_rotate_deg=45.0)
PCR_BATCH, PCR_STEPS, TOL_PCR_LOSS, PROFILED_STEPS = 16, 30, 1e-4, 5
# The autoencoder (the production AUE of results/aue_eval_r4.json: 3dmfv,
# 512 Gaussians, np 64, BN; and the pn AUE) held against the golden JAX
# values (tests/test_torch_aue.py writes them from the port's seeded
# weights, which the card rebuilds): the weights' per-leaf sums within
# TOL_FINGERPRINT (else the card drew other weights), reconstructions within
# TOL_REC, the monitor and the first step's loss within TOL_AUE (relative),
# the first step's gradient norm within TOL_AUE_GNORM (through the frozen
# DPDist loss, whose input gradient jumps where a point's cell or pooling
# argmax switches; chamfer's nearest neighbours switch the same way), and
# the second and third Adam steps' losses within TOL_LATER_STEPS (a step
# moves each weight by lr * sign(g); on the CPU the port's own losses moved
# by up to 1.9e-2 under 1e-6 of input noise, and on the card the pn AUE's
# third step read 3.0e-2 from JAX's).
AUE_STEPS, AUE_TIMED_STEPS = 3, 10
TOL_FINGERPRINT, TOL_REC, TOL_AUE, TOL_LATER_STEPS = 1e-9, 1e-4, 1e-4, 5e-2
TOL_AUE_GNORM = {"ours": 3e-2, "chamfer": 1e-2}
# compare_losses against the golden JAX report: DPDist means within
# TOL_DIST, chamfer and EMD within TOL_CHAMFER / TOL_EMD.
COMPARE_PAIRS = 8 * 20          # 8 surfaces x 20 magnitudes at the CLI's defaults
# The blocked EMD: against the port's CPU run (float32 logsumexps in another
# order) within TOL_EMD_BLOCKED relative, against the dense plan at 10,000
# points within 3 % + 1e-3 (the JAX package's own bound, tests/test_losses.py).
TOL_EMD_BLOCKED = 1e-5
# The 3dmfv PCRNet step against the golden JAX step (tests/test_torch_pcrnet_3dmfv.py's
# tolerances): loss 1e-4 relative, gradient norm 5e-3, the BN state's block
# sums 1e-4, the eval refinement's poses after the step 1e-3.
TOL_PCR3_GNORM, TOL_PCR3_POSES = 5e-3, 1e-3

# Fault 5 (ROADMAP.md §3): row 6 at 128^3 = 2,097,152 queries a cloud (one
# tile of 32 past the 65,535 y-blocks of its old grid; 16,384 runs of 128
# rows of the persistent gather), on a small window (g = 2,
# k = 1, C = 1: 8 MB out), exact; row 3 at N = 860,000, past its old
# 32-bit cloud offsets ((N - 1) * 2,500 + 2,500 > 2^31 - 1), on integer
# grads (exact sums in any order).
FAULT5_QUERIES, FAULT5_ADJOINT_QUERIES = 128 ** 3, 860_000
# The serving export: artifacts of results/ckpt_best and of the production
# policy, exported on the CPU by background processes (`--export-artifacts
# DIR PART`) while the card runs the earlier phases, then loaded onto the card.
# Served calls timed at B = 1 and B = SERVE_TIMED_BATCH (CUDA-event medians
# of SERVE_TIMED_RUNS); the policy under REG_STOP at 50 iterations.
SERVE_EXPORTS = {
    "portable_f32": {},
    "portable_bf16": {"cfg": {"dtype": "bfloat16"}},
    "portable_grad": {"with_grad": True},
    "native_f32": {"portable": False},
    "native_bf16_full": {"portable": False, "cfg": {"dtype": "bfloat16", "fused_gather": "full"}},
    "native_grad": {"portable": False, "with_grad": True},
    "native_on": {"portable": False, "cfg": {"fused_gather": "on"}},
    "native_f32_np256": {"portable": False, "num_point": NP_LARGE},
    # float16: row 1 writes an fp16 x.
    "native_fp16": {"portable": False, "cfg": {"dtype": "float16"}},
}
SERVE_TIMED_BATCH, SERVE_TIMED_RUNS, CLI_POLICY_BATCH = 64, 10, 8
# The exports split over background processes, one a part, balanced by their
# export times on the H100 machine's CPU beside the card's phases.
EXPORT_PARTS = (("portable_f32", "native_f32", "native_bf16_full", "native_grad", "native_on",
                 "native_f32_np256"),
                ("portable_bf16", "policy_fixed", "policy_cli"),
                ("portable_grad", "policy_early", "native_fp16"),
                ("policy3_native_fixed", "policy3_native_early"),
                ("policy3_portable_fixed", "policy3_cli"))
TOL_POLICY = 1e-5        # transforms and aligned clouds, program vs eager
# The 3dmfv policy served as programs (serving_registration_3dmfv):
# PCRNetConfig(encoder="3dmfv")'s defaults (num_point 1024, an 8^3 grid,
# sigma 0.25, out_features 1024, head (1024, 512, 256)) under REG_STOP at
# REG_ITERATIONS, from the weights init_pcrnet draws from
# torch.Generator().manual_seed(POLICY3_SEED) and a BN state drawn after
# them off its init (policy3). Each program against the eager refinement
# at its batch on its route (native: row 7; portable: the plain encode)
# within TOL_POLICY, and timed at B = 1 and SERVE_TIMED_BATCH (CUDA-event
# medians of POLICY3_TIMED_RUNS calls after the checked calls).
POLICY3_SEED, POLICY3_TIMED_RUNS, POLICY3_CLI_BATCH = 3, 3, 4
POLICY3_PROGRAMS = ("native_fixed", "native_early", "portable_fixed")
# Data parallelism on the one card: two processes over gloo, DP_LOCAL_BATCH
# pairs each, held against the single-process step on the whole batch by
# the JAX package's own bound on its data-parallel losses
# (tests/test_train.py:71) and Adam's first-step criterion on the params
# (within 2 lr; within 1e-6 on all but 1 % of them); the sharded field
# within DP_TOL_FIELD of the unsharded one (the decoder's products run on
# half the rows, so cuBLAS may sum in another order). Steps and fields timed
# over DP_TIMED_RUNS calls; the workers stop after DP_WORKER_TIMEOUT_S.
DP_WORLD, DP_LOCAL_BATCH, DP_TIMED_RUNS, DP_WORKER_TIMEOUT_S = 2, 64, 10, 150
DP_LOSS_RTOL, DP_LOSS_ATOL, DP_TOL_FIELD = 2e-3, 1e-5, 1e-5

_phase = "start"
_children = []           # processes this run started, stopped at its end


def _stop_children():
    for proc in _children:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _time_out(*_):
    print(f"chip_smoke: FAILED, time limit of {TIME_LIMIT_S} s hit in phase "
          f"'{_phase}'", flush=True)
    _stop_children()
    os._exit(124)


def _watchdog():
    # Backstop for a main thread stuck in native code, where the SIGALRM
    # handler cannot run.
    time.sleep(TIME_LIMIT_S + 15)
    _time_out()


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        global _phase
        _phase = self.name
        self.t0 = time.perf_counter()
        print(f"[phase {self.name}] start", flush=True)
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t0
        status = "ok" if exc_type is None else f"FAILED ({exc_type.__name__}: {exc})"
        print(f"[phase {self.name}] end {status} after {dt:.2f} s", flush=True)
        return False


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def check_grad_rows(got, want, what):
    """Per-point gradient agreement (see REL_GRAD); returns the largest
    relative error."""
    err = (got - want).abs().amax(dim=-1).flatten() / float(want.abs().max())
    worst, share = float(err.max()), float((err > REL_GRAD).float().mean())
    check(worst <= REL_GRAD_FEW and share <= OUTLIERS,
          f"{what}: worst point {worst:.3e}, share above {REL_GRAD}: {share:.3f}")
    return worst


def cuda_median_ms(fn, runs=TIMED_RUNS, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, match, calls=5, sessions=12):
    """Mean device time (ms) of one launch of the CUDA kernel whose name
    holds `match` (or one of the names in a tuple), which fn launches once a
    call, under torch.profiler. The mean runs over the kernel records the
    profiler kept with a device time, which may be fewer than the calls: it
    drops records of short profiled runs (mostly the first; now and then
    all of them, for six sessions running), and may keep a record with no
    device time, which would halve a mean taken over its count. Sessions
    repeat, up to `sessions`, until `calls` timed records are kept; a
    session that kept none makes the next one twice as long (up to 8
    `calls`). Prints the records' spread where some had no device time or
    the slowest took over 1.5 times the fastest."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    matches = (match,) if isinstance(match, str) else match
    fn()
    torch.cuda.synchronize()
    timed, untimed = [], 0
    length = calls
    for session in range(1, sessions + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(length):
                fn()
            torch.cuda.synchronize()
        kept = [e.self_device_time_total for e in prof.events() if any(m in e.key for m in matches)]
        timed += [us for us in kept if us > 0]
        untimed += sum(us <= 0 for us in kept)
        if len(timed) >= calls:
            break
        if not kept:
            length = min(2 * length, 8 * calls)
    check(len(timed) >= 1, f"torch.profiler kept no timed launch of {match} in {session} "
          f"sessions of {calls} to {length} calls")
    if session > 1 or len(timed) < calls or untimed:
        print(f"torch.profiler kept {len(timed)} timed records of {match} in {session} "
              f"session(s) of {calls} to {length} calls, {untimed} without device time",
              flush=True)
    if untimed or max(timed) > 1.5 * min(timed):
        print(f"  {match}: device us of each timed record {sorted(round(us, 1) for us in timed)}",
              flush=True)
    return sum(timed) / len(timed) / 1e3


def cuda_kernel_names(fn, calls, sessions=6):
    """Names of the CUDA kernels that `calls` calls of fn launch, as
    torch.profiler records them (memsets and copies are not kernels; the
    profiler may drop a record of a short run, now and then every record of
    a session: such a session, with no kernel kept, is run again, up to
    `sessions`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.name.startswith(("Memset", "Memcpy"))]
        if names:
            break
    return names


def sass_loop_counts(lib_path, kernel, op="FMNMX"):
    """The instruction counts of the innermost loop of `kernel` that holds
    the most `op`, in the built library's SASS (cuobjdump): {opcode: n}."""
    import collections
    import re

    from dpdist_tpu_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    body = sass[sass.index(kernel):]
    body = body[:body.find("Function :")] if "Function :" in body else body
    code = [(int(m.group(1), 16), m.group(2), m.group(0)) for m in
            re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)[^;]*;",
                        body)]
    loops = []   # (first, last) address of each backward branch's loop
    for addr, opcode, text in code:
        target = re.search(r"0x([0-9a-f]+)", text)
        if opcode.startswith("BRA") and target and int(target.group(1), 16) < addr:
            loops.append((int(target.group(1), 16), addr))
    best = collections.Counter()
    for lo, hi in loops:
        if any(lo <= a < hi for a2, a in loops if (a2, a) != (lo, hi)):
            continue   # holds another loop
        loop = collections.Counter(o.split(".")[0] for a, o, _ in code if lo <= a <= hi)
        if loop[op] > best[op]:
            best = loop
    return dict(best)


def sm_clock_hz():
    """The card's top SM clock (nvidia-smi clocks.max.sm), in Hz."""
    return 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0])


def bwd_bf16_warp_runs(torch, vox, g, k, C, plan):
    """What the bf16 adjoint's consumers do on these vox (csrc/
    table_gather.cu:table_gather_bwd_b16_kernel): (listed runs, consumer
    warp-runs in which some owner of the warp lies in the run's window and
    so issues the sum). Owner o of a part holds channels (o % Q) * 10 ..
    of cell o // Q, Q = ceil(C / 10); warp w the owners 32 w .. 32 w + 31."""
    from dpdist_tpu_torch.kernels.table_gather import BWD_BF16_GROUP

    gg, kh = g * g, k // 2
    Q = -(-C // BWD_BF16_GROUP)
    v = vox.long().flatten()
    v = v[(v >= 0) & (v < gg * g)]
    slabs = torch.arange(g, device=v.device)
    di = slabs[None] - (v // gg)[:, None] + kh
    hits = ((di >= 0) & (di < k)).sum(1)                           # runs a query
    yz = (v // g % g) * g + v % g
    runs_at = torch.zeros(gg, dtype=torch.long, device=v.device).index_add_(0, yz, hits)
    own = torch.arange(plan["parts"] * plan["consumers"], device=v.device)
    cell = own // Q
    ty, tz = (cell // g)[:, None], (cell % g)[:, None]
    vy, vz = (torch.arange(gg, device=v.device) // g)[None], (torch.arange(gg, device=v.device) % g)[None]
    near = (cell < gg)[:, None] & ((ty - vy).abs() <= kh) & ((tz - vz).abs() <= kh)   # (owners, gg)
    warps = near.view(-1, 32, gg).any(1)                           # (warps, gg)
    return int(runs_at.sum()), int((warps.long().sum(0) * runs_at).sum())


def bound(bytes_moved, flops, peak=F32_FLOP_PER_S):
    """(ms, "bytes" or "operations"): the least time the card could take,
    with the operations at `peak` per second."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def make_kernel_inputs(rng, torch, dev, n_clouds):
    """Encoded clouds inside the grid with some coordinates exactly on cell
    edges; queries partly off-grid, with edges at -1, +1 and in between."""
    import numpy as np

    edges = (-1.0 + (2.0 / GRID) * np.arange(GRID + 1)).astype(np.float32)  # -1 .. 1
    pts = rng.uniform(-0.95, 0.95, (n_clouds, NP, 3)).astype(np.float32)
    on_edge = rng.random(pts.shape) < 0.1
    pts[on_edge] = rng.choice(edges[1:-1], on_edge.sum())
    q = rng.uniform(-1.2, 1.2, (n_clouds, NP, 3)).astype(np.float32)
    on_edge = rng.random(q.shape) < 0.15
    q[on_edge] = rng.choice(edges, on_edge.sum())
    return (torch.as_tensor(pts, device=dev), torch.as_tensor(q, device=dev))


def xavier_layers(rng, torch, dev, in_dim, widths):
    """Random decoder layers [{"w": (in, out), "b": (out,)}] at xavier scale
    (uniform within sqrt(6 / (in + out))), biases N(0, 0.1)."""
    import numpy as np

    layers, d = [], in_dim
    for w in widths:
        lim = np.sqrt(6.0 / (d + w))
        layers.append({"w": torch.as_tensor(rng.uniform(-lim, lim, (d, w)).astype(np.float32),
                                            device=dev),
                       "b": torch.as_tensor(rng.normal(0.0, 0.1, w).astype(np.float32),
                                            device=dev)})
        d = w
    return layers


def make_encode_inputs(rng, torch, dev, B, N):
    """Clouds inside the grid with 10 % of their coordinates on cell edges,
    and about 1 % of their points (the first one at least) far outside."""
    import numpy as np

    edges = (-1.0 + (2.0 / GRID) * np.arange(GRID + 1)).astype(np.float32)
    pts = rng.uniform(-0.95, 0.95, (B, N, 3)).astype(np.float32)
    on_edge = rng.random(pts.shape) < 0.1
    pts[on_edge] = rng.choice(edges[1:-1], on_edge.sum())
    far = rng.random((B, N)) < 0.01
    far[:, 0] = True
    pts[far] = (rng.choice([-1.0, 1.0], (far.sum(), 3)) * FAR).astype(np.float32)
    return torch.as_tensor(pts, device=dev)


def make_requests(rng, torch, dev, n_points=NP):
    """REQUESTS batches of B_SERVE synthetic pairs (chair/box/sphere, x0.8)."""
    import numpy as np
    from dpdist_tpu_torch.data.synthetic import synthetic_surface

    fams = ("chair", "box", "sphere")
    reqs = []
    for r in range(REQUESTS):
        a, b = [], []
        for i in range(B_SERVE):
            seed = int(rng.integers(0, 2 ** 31 - 2))
            a.append(synthetic_surface(fams[i % 3], seed=seed, n_points=n_points) * 0.8)
            b.append(synthetic_surface(fams[(i + r) % 3], seed=seed + 1,
                                       n_points=n_points) * 0.8)
        reqs.append(tuple(torch.as_tensor(np.stack(x).astype(np.float32), device=dev)
                          for x in (a, b)))
    return reqs


def make_train_batch(rng, torch, dev, batch=B_TRAIN):
    """One dataset batch in the reference's layout: batch_data (B, 6N, 3) =
    [surface(2N), near(2N), far(2N)] and labels (B, 4N) = [near_d, far_d],
    the distances of the near and far points to a SURFACE_POINTS-point
    synthetic surface, taken by torch.cdist on the card."""
    import numpy as np
    from dpdist_tpu_torch.data.synthetic import synthetic_surface

    fams = ("chair", "box", "sphere", "torus")
    surf = np.stack([synthetic_surface(fams[i % 4], seed=100 + i, n_points=SURFACE_POINTS) * 0.8
                     for i in range(batch)]).astype(np.float32)
    n2 = 2 * NP
    pick = np.stack([rng.choice(SURFACE_POINTS, 2 * n2, replace=False) for _ in range(batch)])
    samples = np.take_along_axis(surf, pick[..., None], axis=1)
    on_surface = samples[:, :n2]
    near = samples[:, n2:] + rng.normal(0.0, 0.05, (batch, n2, 3)).astype(np.float32)
    far = rng.uniform(-1.0, 1.0, (batch, n2, 3)).astype(np.float32)
    surf_t = torch.as_tensor(surf, device=dev)
    probes = torch.as_tensor(np.concatenate([near, far], axis=1), device=dev)
    labels = torch.cdist(probes, surf_t).amin(dim=-1).cpu().numpy()
    return np.concatenate([on_surface, near, far], axis=1), labels


def reset_counters(counts):
    """Zero each (wrapper, attribute) launch count."""
    for wrapper, attr in counts:
        setattr(wrapper, attr, 0)


def close_bf16_grads(got, want, what):
    """The bf16 criterion (see REL_BF16); returns (worst point, share above
    REL_BF16, cosine)."""
    err = (got - want).abs().amax(dim=-1).flatten() / float(want.abs().max())
    cos = float((got * want).sum() / (got.norm() * want.norm()))
    worst, share = float(err.max()), float((err > REL_BF16).float().mean())
    check(worst <= REL_BF16_FEW and share <= OUTLIERS_BF16 and cos >= MIN_COS_BF16,
          f"{what}: worst point {worst:.3e}, share above {REL_BF16}: {share:.3f}, "
          f"cosine {cos:.6f}")
    return worst, share, cos


def neighbour_rows(torch, vox, n_cells):
    """For each (query, offset) of the k^3 window, the row of its neighbour
    cell in a (B*(V+1), C) volume whose last row per cloud is a zero
    (gather) or sink (scatter) row; and which windows lie inside the grid.
    The index a library call needs to compute a patch gather or its adjoint."""
    kh = K // 2
    dev = vox.device
    o = torch.arange(K ** 3, device=dev)
    shift = torch.stack([o // (K * K) - kh, (o // K) % K - kh, o % K - kh], -1)
    v = vox.long()
    digits = torch.stack([v // (GRID * GRID), (v // GRID) % GRID, v % GRID], -1)
    nb = digits[:, :, None, :] + shift                                  # (B, N, K3, 3)
    inside = ((nb >= 0) & (nb < GRID)).all(-1)
    flat = nb[..., 0] * GRID * GRID + nb[..., 1] * GRID + nb[..., 2]
    base = (torch.arange(vox.shape[0], device=dev) * (n_cells + 1))[:, None, None]
    rows = (base + torch.where(inside, flat, torch.full_like(flat, n_cells))).reshape(-1)
    return rows, inside


def write_cloud(path, pts):
    import numpy as np

    np.savetxt(path, pts, delimiter=",", fmt="%.8g")


def policy3(device):
    """(cfg, params, state) of the 3dmfv policy at full width: init_pcrnet's
    weights from torch.Generator().manual_seed(POLICY3_SEED), then from the
    same generator a BN state off its init (running means N(0, 0.1^2),
    variances U(0.5, 2)), so that the running statistics matter. Drawn on
    the CPU, then moved to `device`: the same numbers everywhere."""
    import torch

    from dpdist_tpu_torch.configs import PCRNetConfig
    from dpdist_tpu_torch.models.pcrnet import init_pcrnet, init_pcrnet_state
    from dpdist_tpu_torch.nn import params_to_device

    cfg = PCRNetConfig(encoder="3dmfv")
    gen = torch.Generator().manual_seed(POLICY3_SEED)
    params = init_pcrnet(cfg, gen, "cpu")
    state = {"mfv_bn": [{k: {"mean": 0.1 * torch.randn(v["mean"].shape, generator=gen),
                             "var": 0.5 + 1.5 * torch.rand(v["var"].shape, generator=gen)}
                         for k, v in blk.items()}
                        for blk in init_pcrnet_state(cfg, "cpu")["mfv_bn"]]}
    return cfg, params_to_device(params, device), params_to_device(state, device)


def _export_policy_cli(ckpt: str, out: Path, name: str, batch: int, *extra):
    """export_serving --pcrnet_ckpt under REG_STOP with early exit into
    out/NAME.pt2; its printed line into out/NAME.json."""
    from dpdist_tpu_torch.cli import export_serving

    stop = REG_STOP
    with contextlib.redirect_stdout(io.StringIO()) as line:
        export_serving.main([
            "--pcrnet_ckpt", ckpt, "--out", str(out / f"{name}.pt2"), "--batch", str(batch),
            "--iterations", str(REG_ITERATIONS), "--stop_threshold", str(stop["stop_threshold"]),
            "--stop_period", str(stop["stop_period"]), "--stop_select", stop["stop_select"],
            "--early_exit", "--device", "cpu", *extra])
    (out / f"{name}.json").write_text(line.getvalue())


def export_artifacts(out: Path, part: int) -> int:
    """The serving artifacts of EXPORT_PARTS[part], exported on the CPU into
    `out` (run as `chip_smoke.py --export-artifacts DIR PART` beside the
    card's phases): the frozen distance of NETS[0] (SERVE_EXPORTS), the
    production policy fixed-length and early exit, the 3dmfv policy
    (policy3) native fixed-length and early exit and portable fixed-length,
    and the export_serving CLI's programs of the production policy and of a
    3dmfv checkpoint written here (native) at static batches. Writes each
    program's export seconds to times_PART.json and the CLIs' lines to
    policy_cli.json and policy3_cli.json."""
    import torch

    sys.path.insert(0, str(ROOT))
    from dpdist_tpu_torch.cli.common import load_pcrnet_checkpoint_state
    from dpdist_tpu_torch.serving import (
        export_frozen_distance,
        export_registration,
        save_exported,
    )
    from dpdist_tpu_torch.train import load_dpdist_checkpoint, params_from_jax
    from dpdist_tpu_torch.train.checkpoint import save_checkpoint

    torch.set_num_threads(1)
    times = {}
    cfg, params, state = load_dpdist_checkpoint(str(ROOT / NETS[0]))
    params, state = params_from_jax(params, "cpu"), params_from_jax(state, "cpu")
    pcfg, pparams, pstate = load_pcrnet_checkpoint_state(str(ROOT / POLICY))
    cfg3, p3, s3 = policy3("cpu")
    for name in EXPORT_PARTS[part]:
        t0 = time.perf_counter()
        ep = None
        if name in SERVE_EXPORTS:
            kw = dict(SERVE_EXPORTS[name])
            ep = export_frozen_distance(params, state, cfg.replace(**kw.pop("cfg", {})),
                                        device="cpu", **kw)
        elif name in ("policy_fixed", "policy_early"):
            ep = export_registration(pparams, pcfg, state=pstate, iterations=REG_ITERATIONS,
                                     device="cpu", early_exit=name == "policy_early",
                                     **REG_STOP)
        elif name == "policy_cli":
            _export_policy_cli(str(ROOT / POLICY), out, name, CLI_POLICY_BATCH)
        elif name == "policy3_cli":
            ckpt = str(out / "policy3_ckpt")
            save_checkpoint(ckpt, {"params": p3, "state": s3},
                            metadata={"pcrnet_config": cfg3.to_json()})
            _export_policy_cli(ckpt, out, name, POLICY3_CLI_BATCH, "--native_kernels")
        else:
            kind = name[len("policy3_"):]
            ep = export_registration(p3, cfg3, state=s3, iterations=REG_ITERATIONS,
                                     portable=kind.startswith("portable"), device="cpu",
                                     early_exit=kind.endswith("early"), **REG_STOP)
        times[name] = time.perf_counter() - t0
        if ep is not None:
            save_exported(ep, str(out / f"{name}.pt2"))
    (out / f"times_{part}.json").write_text(json.dumps(times))
    return 0


def flat_params(tree):
    """{path: tensor} of a tree, detached."""
    from dpdist_tpu_torch.train.checkpoint import tree_flatten_with_paths

    return {p: t.detach() for p, t in tree_flatten_with_paths(tree)}


def dp_worker(rank: int, out: Path) -> int:
    """One of DP_WORLD processes on the one card (run as `chip_smoke.py
    --dp-worker RANK DIR` by the data_parallel phase), in a gloo group met
    through a file store in DIR: the canonical DPDist train step on its
    rows of DIR/batch.npz's global batch (one step, then DP_TIMED_RUNS
    timed), and distance_field's 64^3 queries of results/ckpt_best sharded
    over the points axis (pretransform "off", timed). Writes its launches,
    times, loss and field to DIR/rank<RANK>.npz and .json."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from dpdist_tpu_torch.configs import DPDistConfig, TrainConfig
    from dpdist_tpu_torch.eval.dense import dense_point_to_surface
    from dpdist_tpu_torch.kernels import build
    from dpdist_tpu_torch.kernels.table_gather import table_gather, table_gather_x
    from dpdist_tpu_torch.kernels.threedmfv import threedmfv_kernel
    from dpdist_tpu_torch.parallel import make_mesh
    from dpdist_tpu_torch.train import load_dpdist_checkpoint, params_from_jax
    from dpdist_tpu_torch.train.logging import NullLogger
    from dpdist_tpu_torch.train.trainer import DPDistTrainer

    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    build.library()
    dist.init_process_group("gloo", init_method=f"file://{out / 'gloo_store'}",
                            world_size=DP_WORLD, rank=rank)
    try:
        inputs = np.load(out / "inputs.npz")
        data, labels = inputs["data"], inputs["labels"]
        counters = {"table_gather_x": table_gather_x, "table_gather": table_gather,
                    "threedmfv": threedmfv_kernel}
        res = {"launches": {}}
        mesh = make_mesh(data=DP_WORLD, device=dev)
        tr = DPDistTrainer(DPDistConfig(), TrainConfig(batch_size=data.shape[0], augment=False),
                           run_dir=str(out / f"run{rank}"), mesh=mesh, logger=NullLogger(),
                           device=dev)
        for w in counters.values():
            w.launches = 0
        m = tr.train_step(data, labels)
        res["loss"], res["grad_norm"] = float(m["loss"]), float(m["grad_norm"])
        res["launches"]["step"] = {k: w.launches for k, w in counters.items()}
        params = {p: t.cpu().clone().numpy() for p, t in flat_params(tr.params).items()}
        res["step_ms"] = cuda_median_ms(lambda: tr.train_step(data, labels),
                                        runs=DP_TIMED_RUNS, warmup=2)
        cfg, p_np, s_np = load_dpdist_checkpoint(str(ROOT / NETS[0]))
        dparams, dstate = params_from_jax(p_np, dev), params_from_jax(s_np, dev)
        cloud = torch.as_tensor(inputs["cloud"], device=dev)
        q = torch.as_tensor(inputs["queries"], device=dev)
        pmesh = make_mesh(points=DP_WORLD, device=dev)

        def field():
            with torch.no_grad():
                return dense_point_to_surface(dparams, cfg, cloud, q, state=dstate, mesh=pmesh,
                                              pretransform="off")

        for w in counters.values():
            w.launches = 0
        d = field()
        torch.cuda.synchronize()
        res["launches"]["field"] = {k: w.launches for k, w in counters.items()}
        res["field_ms"] = cuda_median_ms(field, runs=3, warmup=1)
        res["mesh"] = [mesh.index("data"), pmesh.index("points")]
        np.savez(out / f"rank{rank}.npz", field=d.cpu().numpy(), **params)
        (out / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()
    return 0


def main() -> int:
    signal.signal(signal.SIGALRM, _time_out)
    signal.alarm(TIME_LIMIT_S)
    threading.Thread(target=_watchdog, daemon=True).start()
    t_start = time.perf_counter()

    with Phase("device"):
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: FAILED, no CUDA device "
                             "(torch.cuda.is_available() is False)")
        sys.path.insert(0, str(ROOT))
        import numpy as np

        import dpdist_tpu_torch  # noqa: F401  (sets TF32 off)
        from dpdist_tpu_torch.cli import eval_pair
        from dpdist_tpu_torch.cli import eval_registration as eval_registration_cli
        from dpdist_tpu_torch.cli import gen_data as gen_data_cli
        from dpdist_tpu_torch.cli import train_dpdist as train_dpdist_cli
        from dpdist_tpu_torch.cli import compare_losses as compare_losses_cli
        from dpdist_tpu_torch.cli import run_serving as run_serving_cli
        from dpdist_tpu_torch.cli import train_aue as train_aue_cli
        from dpdist_tpu_torch.cli import train_pcrnet as train_pcrnet_cli
        from dpdist_tpu_torch.cli.common import load_pcrnet_checkpoint
        from dpdist_tpu_torch.configs import AUEConfig, DPDistConfig, PCRNetConfig, TrainConfig
        from dpdist_tpu_torch.data import gtgen
        from dpdist_tpu_torch.data.golden import (
            AUE_GOLDEN_PATH,
            FP16_EDGES,
            VARIANTS_GOLDEN_PATH,
            aue_batch,
            beyond_one_ulp,
            dense_field_queries,
            dpdist_train_batch,
            golden_clouds,
            informative_weights,
            load_golden,
            output_spread,
            state_gap,
            state_sample,
            variant_clouds,
        )
        from dpdist_tpu_torch.data.registration import RegistrationDataset, default_eval_poses
        from dpdist_tpu_torch.data.synthetic import synthetic_surface
        from dpdist_tpu_torch.eval import registration
        from dpdist_tpu_torch.eval.dense import dense_point_to_surface, distance_field
        from dpdist_tpu_torch.kernels import build
        from dpdist_tpu_torch.kernels import chamfer as chamfer_kernels
        from dpdist_tpu_torch.kernels.chamfer import nn_min_sqdist, nn_min_sqdist_plain
        from dpdist_tpu_torch.kernels.fused_adam import fused_adam
        from dpdist_tpu_torch.kernels.fused_forward import (
            fused_forward,
            fused_forward_plain,
            pack_decoder,
        )
        from dpdist_tpu_torch.kernels.gather_fused import (
            gather_patches_fused,
            gather_patches_fused_plain,
        )
        from dpdist_tpu_torch.kernels.mfv_gather import mfv_x, mfv_x_plain
        from dpdist_tpu_torch.kernels.table_gather import (
            BWD_BF16_GROUP,
            table_gather,
            table_gather_bwd,
            table_gather_bwd_ordered,
            table_gather_bwd_plain,
            table_gather_plain,
            table_gather_x,
            table_gather_x_plain,
        )
        from dpdist_tpu_torch.kernels.threedmfv import split_plan, threedmfv_kernel
        from dpdist_tpu_torch.losses import make_frozen_dpdist_loss
        from dpdist_tpu_torch.models import apply_dpdist, init_dpdist
        from dpdist_tpu_torch.models.dpdist import forward_dpdist
        from dpdist_tpu_torch.models.dpdist import route as route_of
        from dpdist_tpu_torch.models.aue import apply_aue
        from dpdist_tpu_torch.models.pcrnet import pcrnet_refine
        from dpdist_tpu_torch.native import lib as native_lib
        from dpdist_tpu_torch.nn import mlp_apply, params_to_device
        from dpdist_tpu_torch.ops import (
            chamfer_distance,
            earth_mover_distance,
            neighbor_ids,
            sinkhorn_emd,
            sinkhorn_emd_blocked,
            threedmfv,
            threedmfv_plain,
            voxel_assign,
        )
        from dpdist_tpu_torch.geometry.se3 import apply_transform, invert_transform
        from dpdist_tpu_torch.serving import FrozenDistance, load_exported, load_frozen_distance
        from dpdist_tpu_torch.train import load_dpdist_checkpoint, params_from_jax
        from dpdist_tpu_torch.train.aue_trainer import AUETrainer, split_same_surface
        from dpdist_tpu_torch.train.checkpoint import tree_flatten_with_paths
        from dpdist_tpu_torch.train.logging import RunLogger
        from dpdist_tpu_torch.train.optim import B1, B2, EPS, adam_leaf_plain
        from dpdist_tpu_torch.train.pcrnet_trainer import PCRNetTrainer
        from dpdist_tpu_torch.train.trainer import DPDistTrainer

        dev = torch.device("cuda", 0)
        name = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
        smi = smi.splitlines()[0]
        card = f"{name}, power limit {smi.split(',')[-1].strip()}"
        print(f"device: {name}; nvidia-smi: {smi}; torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}", flush=True)
        check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on")
        check(not torch.backends.cudnn.allow_tf32, "TF32 convolution (cuDNN) is on")
        check(not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
              "bf16 GEMMs may reduce in bf16")
        check(not torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction,
              "fp16 GEMMs may reduce in fp16")

    with Phase("build"):
        # The native host library (g++, for this host's CPU) builds beside nvcc.
        t0 = time.perf_counter()
        native_done = {}

        def build_native():
            try:
                native_done["path"] = native_lib.build()
            except Exception as e:   # reported below, after nvcc
                native_done["error"] = e
            native_done["s"] = time.perf_counter() - t0

        native_thread = threading.Thread(target=build_native)
        native_thread.start()
        lib_path = build.build()
        build.library()
        native_thread.join()
        print(f"built {lib_path.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s "
              f"(nvcc: {build.build_seconds} s; None = found built)", flush=True)
        check("path" in native_done, f"native host library: {native_done.get('error')}")
        native_path = native_done["path"]
        check(native_lib.available(), "the native host library does not load")
        print(f"native host library {native_path.relative_to(ROOT)} built in "
              f"{native_done['s']:.2f} s (g++ {' '.join(native_lib.GXX_FLAGS)})", flush=True)

    # The serving artifacts are exported on the CPU by processes of their
    # own while the card runs the phases before serving_export.
    export_dir = tempfile.TemporaryDirectory()
    export_path = Path(export_dir.name)
    exporters = []
    for part in range(len(EXPORT_PARTS)):
        with open(export_path / f"export_{part}.log", "w") as log:
            exporters.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--export-artifacts",
                 str(export_path), str(part)], stdout=log, stderr=subprocess.STDOUT,
                cwd=str(ROOT)))
    _children.extend(exporters)
    t_export = time.perf_counter()

    def nn_plan(B, N, M):
        """The NN-min kernel's launch plan for these sizes on this card."""
        return chamfer_kernels.plan_nn_min(B, N, M, *chamfer_kernels.sm_occupancy(dev.index))

    rng = np.random.default_rng(0)
    with Phase("kernel"):
        pts, q = make_kernel_inputs(rng, torch, dev, B_KERNEL)
        with torch.no_grad():
            x, vox = mfv_x(pts, q, G, SIGMA, GRID, K)
            torch.cuda.synchronize()
            x_ref, vox_ref = mfv_x_plain(pts, q, G, SIGMA, GRID, K)
        check(x.shape == (B_KERNEL, NP, 3 + K ** 3 * C), f"x shape {tuple(x.shape)}")
        check(bool(torch.isfinite(x).all()), "x has non-finite values")
        err_mfv = float((x - x_ref).abs().max())
        vox_equal = bool(torch.equal(vox, vox_ref.to(torch.int32)))
        off_grid = int((vox_ref == 0).sum())
        print(f"mfv kernel vs plain: max |dx| = {err_mfv:.3e} (tol {TOL_X}), vox equal: "
              f"{vox_equal}, queries in cell 0 (off-grid or cell 0): {off_grid}", flush=True)
        check(err_mfv <= TOL_X, f"max |dx| {err_mfv} > {TOL_X}")
        check(vox_equal, "vox differs from the plain version")
        del x, x_ref

    with Phase("table_kernels"):
        fv = torch.as_tensor(rng.normal(size=(B_SERVE, G, C)).astype(np.float32), device=dev)
        tq = q[:B_SERVE].contiguous()
        with torch.no_grad():
            x, vox = table_gather_x(fv, tq, GRID, K)
            torch.cuda.synchronize()
            x_ref, vox_ref = table_gather_x_plain(fv, tq, GRID, K)
        err_tgx = float((x - x_ref).abs().max())
        check(torch.equal(vox, vox_ref), "table_gather_x: vox differs from the plain version")
        check(torch.equal(x, x_ref), f"table_gather_x: x differs from the plain version "
              f"(max |dx| {err_tgx})")
        gx = torch.as_tensor(rng.normal(size=(B_SERVE, NP, 3 + K ** 3 * C)).astype(np.float32),
                             device=dev)
        grad = gx[..., 3:]            # the patch part of x's gradient, off-grid rows included
        dfv = table_gather_bwd(vox, grad, GRID, K)
        dfv_again = table_gather_bwd(vox, grad, GRID, K)
        torch.cuda.synchronize()
        dfv_ref = table_gather_bwd_plain(vox, grad, GRID, K)
        ordered_equal = bool(torch.equal(dfv, table_gather_bwd_ordered(vox, grad, GRID, K)))
        err_bwd = float((dfv - dfv_ref).abs().max())
        tol_bwd = REL_BWD * float(dfv_ref.abs().max())
        print(f"table_gather_x vs plain: x and vox equal ({int((vox == 0).sum())} queries in "
              f"cell 0); table_gather_bwd vs plain: max |d dfv| = {err_bwd:.3e} (tol "
              f"{tol_bwd:.3e} = {REL_BWD} x max |dfv|), run to run equal: "
              f"{bool(torch.equal(dfv, dfv_again))}, equal to the ordered plain sum: "
              f"{ordered_equal}", flush=True)
        check(err_bwd <= tol_bwd, f"table_gather_bwd: max |d dfv| {err_bwd} > {tol_bwd}")
        check(torch.equal(dfv, dfv_again), "table_gather_bwd differs from run to run")
        check(ordered_equal, "table_gather_bwd differs from the ordered plain sum")
        # The fused kernel's backward against autograd through the plain composition.
        co = torch.as_tensor(rng.normal(size=(B_SERVE, NP, 3 + K ** 3 * C)).astype(np.float32),
                             device=dev)
        grads = []
        for fn in (mfv_x, mfv_x_plain):
            p_, q_ = pts[:B_SERVE].clone().requires_grad_(), tq.clone().requires_grad_()
            xx = fn(p_, q_, G, SIGMA, GRID, K)[0]
            grads.append(torch.autograd.grad((xx * co).sum(), (p_, q_)))
        (dp, dq), (dp_ref, dq_ref) = grads
        check(torch.equal(dq, dq_ref), "mfv backward: dq differs")
        err_mfv_bwd = check_grad_rows(dp, dp_ref, "mfv backward: d points")
        print(f"mfv backward vs plain composition: dq equal, d points worst point "
              f"{err_mfv_bwd:.3e} of max", flush=True)
        del x_ref, gx, grad, dfv_ref, co, grads, dp, dp_ref

    with Phase("encode_kernel"):
        err_enc = 0.0
        for B, N in ((B_SERVE, NP_LARGE), (4, 1000), (1, EVAL_POINTS)):
            pe = make_encode_inputs(rng, torch, dev, B, N)
            with torch.no_grad():
                fve = threedmfv_kernel(pe, G, SIGMA)
                torch.cuda.synchronize()
                fve_ref = threedmfv_plain(pe, G, SIGMA)
            check(fve.shape == (B, G, C), f"encode shape {tuple(fve.shape)}")
            check(bool(torch.isfinite(fve).all()), "encode has non-finite values")
            err = float((fve - fve_ref).abs().max())
            err_enc = max(err_enc, err)
            S, chunk = split_plan(B, N, torch.cuda.get_device_properties(dev).multi_processor_count)
            print(f"encode kernel vs plain at B={B}, N={N} ({S} chunk(s) of {chunk} points per "
                  f"cloud): max |d fv| = {err:.3e} (tol {TOL_X})", flush=True)
            check(err <= TOL_X, f"encode at B={B}, N={N}: max |d fv| {err} > {TOL_X}")
            del fve, fve_ref
        pe = make_encode_inputs(rng, torch, dev, 16, NP_LARGE)
        co = torch.as_tensor(rng.normal(size=(16, G, C)).astype(np.float32), device=dev)
        grads = []
        for fn in (threedmfv_kernel, threedmfv_plain):
            p_ = pe.clone().requires_grad_()
            grads.append(torch.autograd.grad((fn(p_, G, SIGMA) * co).sum(), p_)[0])
        err_enc_bwd = float((grads[0] - grads[1]).abs().max())
        print(f"encode backward (replay) vs autograd through the plain encode at B=16, "
              f"N={NP_LARGE}: max |d| = {err_enc_bwd:.3e} (equal expected)", flush=True)
        check(torch.equal(grads[0], grads[1]), "encode backward differs from the plain encode's")
        del pe, co, grads

    with Phase("gather6_kernel"):
        fv6 = torch.as_tensor(rng.normal(size=(B_SERVE, G, C)).astype(np.float32), device=dev)
        q6 = torch.as_tensor(rng.uniform(-1.2, 1.2, (B_SERVE, NP_LARGE, 3)).astype(np.float32),
                             device=dev)
        vox6 = voxel_assign(q6, GRID)[0]
        with torch.no_grad():
            out6 = table_gather(fv6, vox6, GRID, K)
            torch.cuda.synchronize()
            ref6 = table_gather_plain(fv6, vox6, GRID, K)
        err_tg6 = float((out6 - ref6).abs().max())
        off6 = int((voxel_assign(q6, GRID)[1] == 0).sum())
        print(f"table_gather vs plain at B={B_SERVE}, N={NP_LARGE}: max |d| = {err_tg6:.3e} "
              f"(exact expected), {off6} off-grid queries", flush=True)
        check(off6 > 0, "no off-grid query in the gather check")
        check(torch.equal(out6, ref6), f"table_gather differs from its plain version ({err_tg6})")
        del fv6, q6, vox6, out6, ref6

    with Phase("fault5"):
        # Row 6 at 2,097,152 queries a cloud, and row 3 past 32-bit cloud
        # offsets (ROADMAP.md §3, fault 5); inputs from a generator of their
        # own, so that the later phases' do not move.
        r5 = np.random.default_rng(5)
        g5, k5, c5 = 2, 1, 1
        fv5 = torch.as_tensor(r5.normal(size=(2, g5 ** 3, c5)).astype(np.float32), device=dev)
        vox5 = torch.as_tensor(r5.integers(0, g5 ** 3, (2, FAULT5_QUERIES)).astype(np.int32),
                               device=dev)
        with torch.no_grad():
            ref5 = table_gather_plain(fv5, vox5, g5, k5)
            for dt in (torch.float32, torch.bfloat16):
                out5 = table_gather(fv5, vox5, g5, k5, dtype=dt)
                torch.cuda.synchronize()
                check(torch.equal(out5, ref5.to(dt)),
                      f"row 6 at N={FAULT5_QUERIES} ({dt}) differs from its plain version")
        print(f"fault5: row 6 at B=2, N={FAULT5_QUERIES} ({-(-FAULT5_QUERIES // 128)} runs of "
              f"128 rows a cloud; past the old grid's 65,535 y-blocks), g={g5}, k={k5}, C={c5}: "
              f"float32 and bfloat16 equal to the plain version", flush=True)
        del fv5, vox5, ref5, out5
        n3 = FAULT5_ADJOINT_QUERIES
        vox3 = torch.as_tensor(r5.integers(0, G, (1, n3)).astype(np.int32), device=dev)
        grad3 = torch.randint(-4, 5, (1, n3, K ** 3 * C), dtype=torch.int8, device=dev,
                              generator=torch.Generator(dev).manual_seed(5)).float()
        dfv3 = table_gather_bwd(vox3, grad3, GRID, K)
        torch.cuda.synchronize()
        check(torch.equal(dfv3, table_gather_bwd_plain(vox3, grad3, GRID, K)),
              f"row 3 at N={n3} differs from the plain adjoint")
        print(f"fault5: row 3 at B=1, N={n3} ((N - 1) * {K ** 3 * C} + {K ** 3 * C} = "
              f"{(n3 - 1) * K ** 3 * C + K ** 3 * C} > 2^31 - 1), integer grads: equal to the "
              f"plain adjoint", flush=True)
        del vox3, grad3, dfv3
        torch.cuda.empty_cache()
        # Row 6's time at PR 10's shape (B = 256, N = 256), on its 1-D grid.
        fv6 = torch.as_tensor(r5.normal(size=(B_SERVE, G, C)).astype(np.float32), device=dev)
        q6 = torch.as_tensor(r5.uniform(-1.2, 1.2, (B_SERVE, NP_LARGE, 3)).astype(np.float32),
                             device=dev)
        vox6 = voxel_assign(q6, GRID)[0]
        ms6 = cuda_median_ms(lambda: table_gather(fv6, vox6, GRID, K))
        dev6 = device_ms(lambda: table_gather(fv6, vox6, GRID, K), "table_gather_rows_kernel<float")
        print(f"fault5: row 6 at B={B_SERVE}, N={NP_LARGE} (uniform queries): {ms6:.4f} ms "
              f"(CUDA events), {dev6:.4f} ms device (torch.profiler); on {card}", flush=True)
        del fv6, q6, vox6

    with Phase("chamfer_kernel"):
        err_nn = 0.0
        # The first two shapes draw from the run's generator, the others from
        # their own, so that the later phases' inputs do not depend on this list.
        r_nn = np.random.default_rng(8)
        for i, (B, N, M, scale, dup) in enumerate(NN_SHAPES):
            gen = rng if i < 2 else r_nn
            a_, p_ = (gen.uniform(-1.0, 1.0, (B, n, 3)).astype(np.float32) * np.float32(scale)
                      for n in (N, M))
            if dup:
                p_[:, :min(N, M):2] = a_[:, :min(N, M):2]
            a_, p_ = (torch.as_tensor(t, device=dev) for t in (a_, p_))
            with torch.no_grad():
                d = nn_min_sqdist(a_, p_)
                torch.cuda.synchronize()
                d_ref = nn_min_sqdist_plain(a_, p_)
                again = torch.equal(nn_min_sqdist(a_, p_), d)
                names = cuda_kernel_names(lambda: nn_min_sqdist(a_, p_), NN_PROFILED_CALLS)
            err = float((d - d_ref).abs().max())
            err_nn = max(err_nn, err)
            bad = int(((d - d_ref).abs() > TOL_NN_ABS + TOL_NN_REL * d_ref.abs()).sum())
            zeros = bool((d[:, :min(N, M):2] == 0).all()) if dup else None
            print(f"nn_min_sqdist vs plain at B={B}, N={N}, M={M}, x{scale}"
                  f"{', duplicated points' if dup else ''}: max |d| = {err:.3e}, entries "
                  f"outside {TOL_NN_ABS} + {TOL_NN_REL}|d|: {bad}; run to run equal: {again}; "
                  f"CUDA kernels of {NN_PROFILED_CALLS} calls: {sorted(set(names))} x "
                  f"{len(names)}" + (f"; d = 0 where duplicated: {zeros}" if dup else ""),
                  flush=True)
            check(bad == 0, f"nn_min_sqdist at B={B}, N={N}, M={M} disagrees on {bad} entries")
            check(again, f"nn_min_sqdist at B={B}, N={N}, M={M} differs from run to run")
            # nn_min_kernel and nothing else, at most once a call; at least
            # once shows in dist, which the memset fills with NaN bits.
            check(1 <= len(names) <= NN_PROFILED_CALLS
                  and all("nn_min_kernel" in n for n in names),
                  f"nn_min_sqdist at B={B}, N={N}, M={M}: CUDA kernels {names}")
            check(zeros is not False, "nn_min_sqdist: a duplicated point is not at distance 0")
        a10, b10 = (torch.as_tensor(rng.uniform(-1.0, 1.0, (1, EVAL_POINTS, 3)).astype(np.float32),
                                    device=dev) for _ in range(2))
        with torch.no_grad():
            for sq in (True, False):
                got = float(chamfer_distance(a10, b10, sqrt=sq))
                want = float(chamfer_distance(a10, b10, sqrt=sq, impl="plain"))
                print(f"chamfer_distance (sqrt={sq}) at {EVAL_POINTS} x {EVAL_POINTS}: kernel "
                      f"path {got:.7f}, plain path {want:.7f}, |d| = {abs(got - want):.3e} "
                      f"(tol {TOL_CHAMFER})", flush=True)
                check(abs(got - want) <= TOL_CHAMFER, "chamfer_distance: kernel vs plain path")
        del a_, p_, d, d_ref, a10, b10

    # name -> (wrapper, attribute of its launch count); row 3 counts its
    # two-byte kernel on bfloat16 and on float16 grads apart from its
    # float32 one.
    counters = {name: (w, "launches") for name, w in (
        ("mfv_gather_x", mfv_x), ("table_gather_x", table_gather_x),
        ("table_gather_bwd", table_gather_bwd), ("threedmfv", threedmfv_kernel),
        ("table_gather", table_gather), ("nn_min_sqdist", nn_min_sqdist),
        ("fused_forward", fused_forward), ("gather_patches_fused", gather_patches_fused))}
    counters["table_gather_bwd_bf16"] = (table_gather_bwd, "launches_bf16")
    counters["table_gather_bwd_fp16"] = (table_gather_bwd, "launches_fp16")
    launches = dict.fromkeys(counters, 0)
    # Adam's kernel: one launch a training step, read where a phase trains
    # (train, aue) and added to the totals there.
    launches["fused_adam"] = 0

    def start_count():
        reset_counters(counters.values())
        threedmfv_kernel.replays = 0
        fused_adam.launches = 0

    def read_count():
        """The launches since start_count, added to the run's main-path totals."""
        torch.cuda.synchronize()
        launched = {k: getattr(w, attr) for k, (w, attr) in counters.items()}
        for k in launched:
            launches[k] += launched[k]
        return launched

    def expected(**nonzero):
        return {k: nonzero.get(k, 0) for k in counters}

    golden = load_golden()
    large = golden["np256"]
    gA, gB = (torch.as_tensor(a, device=dev) for a in golden_clouds(golden))
    gA_large, gB_large = (torch.as_tensor(a, device=dev)
                          for a in golden_clouds(golden, large["num_point"]))

    def serve(requests, section, clouds, want):
        """Per committed net: the requests through load_frozen_distance,
        counted; outputs against the plain path and the section's golden
        distances. Returns the last net's model."""
        n_points = requests[0][0].shape[1]
        for net in NETS:
            model = load_frozen_distance(str(ROOT / net), device=dev)
            plain = load_frozen_distance(str(ROOT / net), device=dev, fused_gather="off")
            start_count()
            with torch.no_grad():
                outs = [model(a, b) for a, b in requests]
            launched = read_count()
            print(f"{net}: {REQUESTS} requests of {B_SERVE} pairs at np={n_points}, kernel "
                  f"launches {launched}", flush=True)
            check(launched == want, f"{net}: unexpected launches")
            with torch.no_grad():
                refs = [plain(a, b) for a, b in requests]
                got_golden = model(*clouds).cpu().numpy()
            for out in outs:
                check(out.shape == (B_SERVE,), f"output shape {tuple(out.shape)}")
                check(bool(torch.isfinite(out).all()), "non-finite distance")
                check(float(out.min()) >= 0.0 and float(out.max()) <= 2.0,
                      f"distance outside [0, 2]: {float(out.min())}..{float(out.max())}")
            err_plain = max(float((o - r).abs().max()) for o, r in zip(outs, refs))
            err_golden = float(np.abs(got_golden - np.asarray(section["distance"][net])).max())
            print(f"{net}: distances {float(outs[0].min()):.4f}..{float(outs[0].max()):.4f}; "
                  f"kernel path vs plain path max |d| = {err_plain:.3e}; vs JAX golden "
                  f"max |d| = {err_golden:.3e} (tol {TOL_DIST})", flush=True)
            check(err_plain <= TOL_DIST, f"{net}: kernel vs plain path {err_plain}")
            check(err_golden <= TOL_DIST, f"{net}: vs golden {err_golden}")
        return model

    with Phase("serving"):
        requests = make_requests(rng, torch, dev)
        fwd_model = serve(requests, golden, (gA, gB), expected(mfv_gather_x=REQUESTS))

    with Phase("serving_large"):
        requests_large = make_requests(rng, torch, dev, NP_LARGE)
        fwd_model_large = serve(requests_large, large, (gA_large, gB_large),
                                expected(threedmfv=2 * REQUESTS, table_gather=2 * REQUESTS))

    def src_grad(loss_fn, a, b):
        a = a.detach().requires_grad_(True)
        value = loss_fn(a, b)
        (g,) = torch.autograd.grad(value, a)
        return value.detach(), g

    def frozen_grad(requests, section, clouds, want, replays, other_modes, mode=None):
        """Per committed net: the frozen loss and d/dpcA on the section's
        golden pairs against the JAX values; source-gradient calls on the
        requests, counted, against the paths of other_modes; the parameters
        unchanged and without .grad. `mode` sets fused_gather (default: the
        checkpoint's, "auto", which a gradient context resolves as
        "table")."""
        gold = section["frozen_loss"]
        rows = gold["grad_pairs"]
        n_points = requests[0][0].shape[1]
        label = mode or "table"
        for net in NETS:
            cfg, np_params, _ = load_dpdist_checkpoint(str(ROOT / net))
            if mode:
                cfg = cfg.replace(fused_gather=mode)
            params = params_from_jax(np_params, dev)
            leaves = [t.requires_grad_(True) for lp in params["decoder"]["layers"]
                      for t in lp.values()]
            before = [t.detach().clone() for t in leaves]
            loss_fn = make_frozen_dpdist_loss(params, cfg,
                                              out_of_grid_penalty=gold["out_of_grid_penalty"])
            value, g = src_grad(loss_fn, *clouds)
            err_value = abs(float(value) - gold[net]["value"])
            worst = check_grad_rows(g[rows], torch.as_tensor(gold[net]["grad_pcA"], device=dev),
                                    f"{net}: golden d/dpcA")
            print(f"{net}: golden frozen loss at np={clouds[0].shape[1]} |d| = {err_value:.3e} "
                  f"(tol {TOL_DIST}); d/dpcA worst point {worst:.3e} of max", flush=True)
            check(err_value <= TOL_DIST, f"{net}: golden frozen loss off by {err_value}")

            start_count()
            outs = [src_grad(loss_fn, a, b) for a, b in requests]
            launched = read_count()
            print(f"{net}: {REQUESTS} source-gradient calls of {B_SERVE} pairs at "
                  f"np={n_points}, kernel launches {launched}, encode replays "
                  f"{threedmfv_kernel.replays}", flush=True)
            check(launched == want, f"{net}: unexpected launches")
            check(threedmfv_kernel.replays == replays, f"{net}: unexpected encode replays")
            for other_mode in other_modes:
                other = make_frozen_dpdist_loss(params, cfg.replace(fused_gather=other_mode))
                for (v, g), (a, b) in zip(outs, requests):
                    v_ref, g_ref = src_grad(other, a, b)
                    check(bool(torch.isfinite(g).all()), "non-finite gradient")
                    d = abs(float(v - v_ref))
                    worst = check_grad_rows(g, g_ref, f"{net}: {label} vs {other_mode} path")
                    check(d <= TOL_DIST, f"{net}: loss, {label} vs {other_mode} path: {d}")
                print(f"{net}: {label} path vs {other_mode} path: loss |d| = {d:.3e}, d/dpcA "
                      f"worst point {worst:.3e} of max (last request)", flush=True)
            check(all(t.grad is None for t in leaves), f"{net}: a parameter received .grad")
            check(all(torch.equal(t, b) for t, b in zip(leaves, before)),
                  f"{net}: a parameter changed")

    with Phase("frozen_grad"):
        frozen_grad(requests, golden, (gA, gB),
                    expected(table_gather_x=2 * REQUESTS, table_gather_bwd=REQUESTS), 0,
                    ("off", "mfv"))

    with Phase("frozen_grad_large"):
        # One encode replay per call: pcA's. pcB needs no gradient, so its
        # encode is not replayed, and its surface needs no adjoint.
        frozen_grad(requests_large, large, (gA_large, gB_large),
                    expected(threedmfv=2 * REQUESTS, table_gather=2 * REQUESTS,
                             table_gather_bwd=REQUESTS), REQUESTS, ("off",))

    with Phase("train"), tempfile.TemporaryDirectory() as tmp:
        mcfg, tcfg = DPDistConfig(), TrainConfig(batch_size=B_TRAIN, augment=False)
        data, labels = make_train_batch(rng, torch, dev)
        trainer = DPDistTrainer(mcfg, tcfg, run_dir=os.path.join(tmp, "run"), device=dev,
                                logger=RunLogger(os.path.join(tmp, "run"), echo=False))
        start = [t.detach().clone() for lp in trainer.params["decoder"]["layers"]
                 for t in lp.values()]
        start_count()
        losses = [trainer.train_step(data, labels)["loss"] for _ in range(TRAIN_STEPS)]
        launched = read_count()
        launches["fused_adam"] += fused_adam.launches
        losses = torch.stack(losses).cpu().numpy()
        print(f"train: {TRAIN_STEPS} steps at B={B_TRAIN}, kernel launches {launched}, Adam "
              f"{fused_adam.launches}; loss {losses[0]:.5f} -> {losses[-1]:.5f} (first 5 mean "
              f"{losses[:5].mean():.5f}, last 5 mean {losses[-5:].mean():.5f})", flush=True)
        check(launched == expected(table_gather_x=TRAIN_STEPS), "train: unexpected launches")
        check(fused_adam.launches == TRAIN_STEPS, "train: not one Adam launch a step")
        check(bool(np.isfinite(losses).all()), "train: non-finite loss")
        check(losses[-5:].mean() < losses[:5].mean(), "train: the loss did not fall")

        # One step on the kernel path and on the plain path from the same
        # params, restored from a checkpoint of the trained ones.
        path = trainer.save(tag="smoke")
        steps = []
        for mode in ("auto", "off"):
            t = DPDistTrainer(mcfg.replace(fused_gather=mode), tcfg,
                              run_dir=os.path.join(tmp, mode), device=dev,
                              logger=RunLogger(os.path.join(tmp, mode), echo=False))
            t.restore(path)
            loss, grads = t.loss_and_grads(*t.make_batch(data, labels))
            t.train_step(data, labels)
            steps.append((float(loss), grads, [p.detach() for lp in t.params["decoder"]["layers"]
                                               for p in (lp["b"], lp["w"])]))
        (l_k, g_k, p_k), (l_p, g_p, p_p) = steps
        err_loss = abs(l_k - l_p)
        err_g = max(float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(g_k, g_p))
        lr = tcfg.learning_rate
        bad = 0
        for a, b, gref in zip(p_k, p_p, g_p):
            diff = (a - b).abs()
            bad += int((diff[gref.abs() > 1e-6] > 1e-6).sum()) + int((diff > 2 * lr + 1e-6).sum())
        print(f"train step, kernel path vs plain path: loss |d| = {err_loss:.3e}, grads worst "
              f"{err_g:.3e} of max, params after the step outside tolerance: {bad}", flush=True)
        check(err_loss <= 1e-5 and err_g <= REL_GRAD and bad == 0,
              "train step: kernel path and plain path disagree")

        restored = DPDistTrainer(mcfg, tcfg, run_dir=os.path.join(tmp, "restored"), device=dev,
                                 logger=RunLogger(os.path.join(tmp, "restored"), echo=False))
        restored.restore(path)
        same = all(torch.equal(a, b) for la, lb in zip(trainer.params["decoder"]["layers"],
                                                       restored.params["decoder"]["layers"])
                   for a, b in ((la["w"], lb["w"]), (la["b"], lb["b"])))
        moved = any(not torch.equal(v, t) for v, t in zip(
            start, (t for lp in trainer.params["decoder"]["layers"] for t in lp.values())))
        print(f"train: save -> restore equal: {same}; params moved from init: {moved}", flush=True)
        check(same and moved and restored.global_step == trainer.global_step,
              "train: save -> restore")
        del restored, steps

    with Phase("eval_pair_large"), tempfile.TemporaryDirectory() as tmp:
        files = []
        for fname, family, seed in (("a.txt", "chair", 7), ("b.txt", "box", 8)):
            files.append(os.path.join(tmp, fname))
            write_cloud(files[-1], synthetic_surface(family, seed=seed,
                                                     n_points=EVAL_POINTS) * 0.8)
        eval_args = ["--dpdist_ckpt", str(ROOT / NETS[0]), "--cloud_a", files[0],
                     "--cloud_b", files[1], "--num_point", str(EVAL_POINTS)]
        start_count()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            t0 = time.perf_counter()
            result = eval_pair.main(eval_args)
            torch.cuda.synchronize()
            eval_s = time.perf_counter() - t0
        launched = read_count()
        print(f"eval_pair on two {EVAL_POINTS}-point clouds: {result} in {eval_s:.3f} s "
              f"(first call), kernel launches {launched}", flush=True)
        check(json.loads(printed.getvalue()) == result, "eval_pair printed another result")
        check(launched == expected(threedmfv=2, table_gather=2, nn_min_sqdist=2),
              "eval_pair: unexpected launches")
        # The same clouds through the port's plain path.
        eA, eB = (torch.as_tensor(np.loadtxt(f, delimiter=",")[None].astype(np.float32),
                                  device=dev) for f in files)
        plain = load_frozen_distance(str(ROOT / NETS[0]), device=dev, fused_gather="off")
        with torch.no_grad():
            want = {"dpdist": float(plain(eA, eB).mean()),
                    "chamfer": float(chamfer_distance(eA, eB, impl="plain")),
                    "emd": float(earth_mover_distance(eA, eB))}
        diffs = {k: abs(result[k] - want[k]) for k in want}
        print(f"eval_pair vs the plain path: {want}; |d| {diffs} (tol dpdist {TOL_DIST}, "
              f"chamfer {TOL_CHAMFER}, emd {TOL_EMD})", flush=True)
        check(all(np.isfinite(list(result.values()))), "eval_pair: non-finite result")
        check(diffs["dpdist"] <= TOL_DIST and diffs["chamfer"] <= TOL_CHAMFER
              and diffs["emd"] <= TOL_EMD, "eval_pair: kernel path vs plain path")
        # The golden np = 256 pairs' chamfer and EMD on the card.
        with torch.no_grad():
            g_chamfer = [float(chamfer_distance(gA_large[i:i + 1], gB_large[i:i + 1]))
                         for i in range(gA_large.shape[0])]
            g_emd = sinkhorn_emd(gA_large, gB_large).cpu().numpy()
        err_c = float(np.abs(np.asarray(g_chamfer) - np.asarray(large["chamfer"])).max())
        err_e = float(np.abs(g_emd - np.asarray(large["emd"])).max())
        print(f"golden np={NP_LARGE} pairs vs JAX: chamfer max |d| = {err_c:.3e} (tol "
              f"{TOL_CHAMFER}), EMD max |d| = {err_e:.3e} (tol {TOL_EMD})", flush=True)
        check(err_c <= TOL_CHAMFER and err_e <= TOL_EMD, "golden chamfer / EMD")
        del plain
        # End to end (checkpoint load, file parse, the three keys), host
        # clock, warm.
        walls = []
        for _ in range(3):
            with contextlib.redirect_stdout(io.StringIO()):
                t0 = time.perf_counter()
                eval_pair.main(eval_args)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
        eval_e2e_ms = statistics.median(walls) * 1e3

    def push_off_grid(clouds):
        """A copy with OFF_GRID_SHARE of each cloud's points (the first one
        at least) moved far outside the grid."""
        out = clouds.clone()
        far = torch.as_tensor(rng.random(out.shape[:2]) < OFF_GRID_SHARE, device=dev)
        far[:, 0] = True
        out[far] = FAR
        return out

    def ff_inputs(a, b, off_grid):
        """Row 9's inputs for one request, as the "full" route builds them:
        the bf16 volumes [A; B] and the queries [B; A] (pushed partly off
        the grid if asked)."""
        with torch.no_grad():
            fv2 = torch.cat([threedmfv(a, G, SIGMA), threedmfv(b, G, SIGMA)]).to(torch.bfloat16)
        q2 = torch.cat([b, a])
        if off_grid:
            q2 = push_off_grid(q2)
        vox2, mask2, delta2 = voxel_assign(q2, GRID)
        return fv2, vox2, mask2, delta2

    cfg0, np_params0, _ = load_dpdist_checkpoint(str(ROOT / NETS[0]))
    params0 = params_from_jax(np_params0, dev)
    packed0 = pack_decoder(params0["decoder"]["layers"])

    def fused_forward_f64(fv2, vox2, delta2, packed):
        """fused_forward_plain's rounding points with float64 sums: the
        yardstick for how far float32 summation moves the outputs. The
        pack holds each W as W^T, padded with zeros."""
        x = torch.cat([table_gather_plain(fv2.float(), vox2, GRID, K).double(),
                       delta2.to(torch.bfloat16).double()], -1)
        h = torch.relu(x @ packed.w[0][:, :packed.in_dim].double().t() + packed.b[0].double())
        for w_, b_ in zip(packed.w[1:], packed.b[1:]):
            h = torch.relu(h.to(torch.bfloat16).double() @ w_.double().t() + b_.double())
        return h.to(torch.bfloat16).double() @ packed.w_out.t().double() + packed.b_out.double()

    with Phase("fused_forward_kernel"):
        err_ff = 0.0
        for reqs in (requests, requests_large):
            fv2, vox2, mask2, delta2 = ff_inputs(*reqs[0], off_grid=True)
            with torch.no_grad():
                y = fused_forward(fv2, vox2, delta2, packed0, GRID, K)
                torch.cuda.synchronize()
                y_ref = fused_forward_plain(fv2, vox2, delta2, packed0, GRID, K)
                y64 = fused_forward_f64(fv2, vox2, delta2, packed0)
            n_q = vox2.shape[1]
            check(y.shape == (2 * B_SERVE, n_q, 3), f"fused_forward shape {tuple(y.shape)}")
            check(bool(torch.isfinite(y).all()), "fused_forward has non-finite values")
            err = float((y - y_ref).abs().max())
            err_ff = max(err_ff, err)
            inside = mask2 > 0
            vs64 = {k_: ((v_.double() - y64).abs()[inside].max().item(),
                         (v_.double() - y64).abs()[~inside].max().item())
                    for k_, v_ in (("kernel", y), ("plain", y_ref))}
            print(f"fused_forward vs plain at 2B={2 * B_SERVE}, N={n_q} ({NETS[0]}): max |dy| = "
                  f"{err:.3e} (tol {TOL_FF}; max |y| {float(y_ref.abs().max()):.2f}), "
                  f"{int((~inside).sum())} off-grid queries; against float64 sums (in-grid, "
                  f"off-grid rows): kernel {vs64['kernel'][0]:.3e}, {vs64['kernel'][1]:.3e}; "
                  f"plain {vs64['plain'][0]:.3e}, {vs64['plain'][1]:.3e}", flush=True)
            check(err <= TOL_FF, f"fused_forward: max |dy| {err} > {TOL_FF}")
            del y, y_ref, y64

    with Phase("gather_fused_kernel"):
        a, b = requests[0]
        fv10 = threedmfv(a, G, SIGMA).detach()
        vox10, mask10, _ = voxel_assign(push_off_grid(b), GRID)
        with torch.no_grad():
            out10 = gather_patches_fused(fv10, vox10, mask10, GRID, K)
            torch.cuda.synchronize()
            ref10 = gather_patches_fused_plain(fv10, vox10, mask10, GRID, K)
        err_g10 = float((out10 - ref10).abs().max())
        check(torch.equal(out10, ref10), f"gather_patches_fused differs from its plain version "
              f"({err_g10})")
        grad10 = torch.as_tensor(rng.normal(size=out10.shape).astype(np.float32), device=dev)
        dfvs = []
        for fn in (gather_patches_fused, gather_patches_fused_plain):
            f = fv10.clone().requires_grad_()
            dfvs.append(torch.autograd.grad(fn(f, vox10, mask10, GRID, K), f, grad10)[0])
        err_g10_bwd = float((dfvs[0] - dfvs[1]).abs().max())
        tol_g10_bwd = REL_BWD * float(dfvs[1].abs().max())
        print(f"gather_patches_fused vs plain at B={B_SERVE}, N={NP}: equal, "
              f"{int((mask10 == 0).sum())} off-grid queries; backward (adjoint on the masked "
              f"grad) vs autograd: max |d dfv| = {err_g10_bwd:.3e} (tol {tol_g10_bwd:.3e})",
              flush=True)
        check(err_g10_bwd <= tol_g10_bwd, "gather_patches_fused backward vs autograd")
        del out10, ref10, grad10, dfvs

    with Phase("bf16_kernels"):
        # The main path's shapes: row 1 over the np = 64 2B stack, row 2 on
        # a request's queries, row 6 at np = 256.
        bf = torch.bfloat16
        aL, bL = requests_large[0]
        fvL6 = threedmfv(aL, G, SIGMA).detach()
        voxL6 = voxel_assign(push_off_grid(bL), GRID)[0]
        with torch.no_grad():
            pairs = {
                "mfv_gather_x": (mfv_x(pts, q, G, SIGMA, GRID, K, dtype=bf)[0],
                                 mfv_x(pts, q, G, SIGMA, GRID, K)[0]),
                "table_gather_x": (table_gather_x(fv, b, GRID, K, dtype=bf)[0],
                                   table_gather_x(fv, b, GRID, K)[0]),
                "table_gather": (table_gather(fvL6, voxL6, GRID, K, dtype=bf),
                                 table_gather(fvL6, voxL6, GRID, K)),
            }
        torch.cuda.synchronize()
        bf16_equal = {}
        for name_, (got, f32) in pairs.items():
            rounded = f32.to(bf)
            # One bf16 ulp of the rounded value: 2^(exponent - 7).
            ulp = torch.ldexp(torch.ones_like(f32), torch.frexp(rounded.float())[1] - 8)
            off = ((got.float() - rounded.float()).abs() > ulp).sum()
            bf16_equal[name_] = bool(torch.equal(got, rounded))
            print(f"{name_} bf16 output vs its float32 output rounded: equal "
                  f"{bf16_equal[name_]}, entries beyond one ulp {int(off)}", flush=True)
            check(got.dtype == bf and int(off) == 0, f"{name_}: bf16 output off by > 1 ulp")
        del pairs

    def edge_queries(r, B, N):
        """Queries partly off the grid, 15 % of their coordinates on cell
        edges (-1 and +1 included)."""
        edges = (-1.0 + (2.0 / GRID) * np.arange(GRID + 1)).astype(np.float32)
        qq = r.uniform(-1.2, 1.2, (B, N, 3)).astype(np.float32)
        on_edge = r.random(qq.shape) < 0.15
        qq[on_edge] = r.choice(edges, on_edge.sum())
        return torch.as_tensor(qq, device=dev)

    with Phase("bf16_adjoint_kernel"):
        # Row 3 on a bf16 grad at the bf16 frozen loss's shapes: the strided
        # patch part of a bf16 x's gradient at N = 64 (rows 2 and 1), a
        # contiguous one at N = 256 (row 6).
        bf = torch.bfloat16
        r3 = np.random.default_rng(31)
        err_bwd16 = 0.0
        for n_q, strided in ((NP, True), (NP_LARGE, False)):
            vox16 = voxel_assign(edge_queries(r3, B_SERVE, n_q), GRID)[0]
            g16 = torch.as_tensor(r3.normal(size=(B_SERVE, n_q, 3 + K ** 3 * C)).astype(np.float32),
                                  device=dev).to(bf)
            g16 = g16[..., 3:] if strided else g16[..., 3:].contiguous()
            dfv16 = table_gather_bwd(vox16, g16, GRID, K)
            # Run to run: 50 calls back to back, each equal to the first.
            runs16 = [table_gather_bwd(vox16, g16, GRID, K) for _ in range(50)]
            torch.cuda.synchronize()
            same16 = sum(torch.equal(dfv16, o) for o in runs16)
            del runs16
            ordered16 = table_gather_bwd_ordered(vox16, g16, GRID, K)
            exact = table_gather_bwd_plain(vox16, g16.double(), GRID, K)
            rounded = exact.to(bf)
            # One bf16 ulp of each exact value: a float32 sum rounded once.
            ulp = torch.ldexp(torch.ones_like(exact), torch.frexp(rounded.double())[1] - 8)
            off = int(((dfv16.double() - exact).abs() > ulp).sum())
            err = float((dfv16.double() - exact).abs().max())
            err_bwd16 = max(err_bwd16, float((dfv16.float() - table_gather_bwd_plain(
                vox16, g16, GRID, K).float()).abs().max()))
            print(f"table_gather_bwd bf16 at B={B_SERVE}, N={n_q} ({'strided' if strided else 'contiguous'} "
                  f"grad, {int((vox16 == 0).sum())} queries in cell 0): equal to the ordered plain sum "
                  f"{bool(torch.equal(dfv16, ordered16))}, run to run {same16} of 50 calls equal; "
                  f"vs float64 sums max |d| = {err:.3e}, entries beyond one bf16 ulp {off}; "
                  f"equal to the float64 sums rounded: {float((dfv16 == rounded).float().mean()):.4f}",
                  flush=True)
            check(dfv16.dtype == bf and torch.equal(dfv16, ordered16),
                  f"table_gather_bwd bf16 at N={n_q} differs from the ordered plain sum")
            check(same16 == 50, f"table_gather_bwd bf16 at N={n_q}: run to run")
            check(off == 0, f"table_gather_bwd bf16 at N={n_q}: {off} entries beyond one ulp")
        err_bwd_half = {"bf16": err_bwd16}
        del dfv16, ordered16, exact, rounded, g16

    with Phase("fp16_kernels"):
        # Rows 1, 2 and 6 with a float16 output at the main path's shapes
        # (as bf16_kernels), equal to their float32 outputs rounded once;
        # rows 2 and 6 on a volume of float16's edge values, equal to the
        # float32 rows rounded by numpy on the host; row 3 on fp16 grads
        # (as bf16_adjoint_kernel, on inputs of its own): equal to the
        # ordered float32 sum rounded once, the same from run to run, within
        # one fp16 ulp of float64 sums (beyond the float32 sums' own error),
        # and on sums that leave float16's range (to inf) or land in its
        # subnormals.
        h = torch.float16
        r16 = np.random.default_rng(16)
        a16, b16 = requests[0]
        with torch.no_grad():
            pairs = {
                "mfv_gather_x": (mfv_x(pts, q, G, SIGMA, GRID, K, dtype=h)[0],
                                 mfv_x(pts, q, G, SIGMA, GRID, K)[0]),
                "table_gather_x": (table_gather_x(fv, b16, GRID, K, dtype=h)[0],
                                   table_gather_x(fv, b16, GRID, K)[0]),
                "table_gather": (table_gather(fvL6, voxL6, GRID, K, dtype=h),
                                 table_gather(fvL6, voxL6, GRID, K)),
            }
            # 32 clouds of the request: the host's rounding is the slow part.
            fv_edge = torch.as_tensor(r16.choice(np.concatenate([FP16_EDGES, -FP16_EDGES]),
                                                 (32, G, C)).astype(np.float32), device=dev)
            b_edge = b16[:32].contiguous()
            x_edge = table_gather_x(fv_edge, b_edge, GRID, K, dtype=h)[0]
            x_edge32 = table_gather_x(fv_edge, b_edge, GRID, K)[0]
            vox_edge = voxel_assign(b_edge, GRID)[0]
            rows_edge = table_gather(fv_edge, vox_edge, GRID, K, dtype=h)
            rows_edge32 = table_gather(fv_edge, vox_edge, GRID, K)
        torch.cuda.synchronize()
        for name_, (got, f32) in pairs.items():
            equal = bool(torch.equal(got, f32.to(h)))
            print(f"{name_} fp16 output vs its float32 output rounded: equal {equal}", flush=True)
            check(got.dtype == h and equal, f"{name_}: fp16 output is not the float32 one rounded")
        del pairs
        with np.errstate(over="ignore"):   # past 65,504 to inf, as the kernels round
            host = [f32.cpu().numpy().astype(np.float16) for f32 in (x_edge32, rows_edge32)]
        for name_, got, want in (("table_gather_x", x_edge, host[0]),
                                 ("table_gather", rows_edge, host[1])):
            bits = got.cpu().numpy().view(np.uint16)
            same = bool(np.array_equal(bits, want.view(np.uint16)))
            n_inf, n_sub = int(torch.isinf(got).sum()), int(((got != 0) & (got.abs() < 2.0 ** -14)).sum())
            print(f"{name_} fp16 on float16's edge values vs numpy's rounding on the host: "
                  f"bit for bit {same} ({n_inf} infs, {n_sub} subnormals)", flush=True)
            check(same and n_inf > 0 and n_sub > 0, f"{name_}: fp16 edges not rounded as a cast")
        del x_edge, x_edge32, rows_edge, rows_edge32, fv_edge, host
        gen = torch.Generator(dev).manual_seed(16)
        for n_q, strided in ((NP, True), (NP_LARGE, False)):
            q16 = torch.as_tensor(r16.uniform(-1.2, 1.2, (B_SERVE, n_q, 3)).astype(np.float32),
                                  device=dev)
            vox16 = voxel_assign(q16, GRID)[0]
            g16 = torch.randn((B_SERVE, n_q, 3 + K ** 3 * C), generator=gen, device=dev).to(h)
            g16 = g16[..., 3:] if strided else g16[..., 3:].contiguous()
            dfv16 = table_gather_bwd(vox16, g16, GRID, K)
            same16 = sum(torch.equal(dfv16, table_gather_bwd(vox16, g16, GRID, K))
                         for _ in range(10))
            ordered16 = table_gather_bwd_ordered(vox16, g16, GRID, K)
            exact = table_gather_bwd_plain(vox16, g16.double(), GRID, K)
            # One fp16 ulp of the float64 sums beyond the float32 sums' own
            # distance from them (the kernel rounds the float32 sum).
            beyond = beyond_one_ulp(dfv16, exact)
            off = beyond_one_ulp(dfv16, exact, table_gather_bwd_ordered(vox16, g16.float(),
                                                                       GRID, K))
            layout = "strided" if strided else "contiguous"
            print(f"table_gather_bwd fp16 at B={B_SERVE}, N={n_q} ({layout} grad): equal to "
                  f"the ordered plain sum "
                  f"{bool(torch.equal(dfv16, ordered16))}, run to run {same16} of 10 calls equal; "
                  f"entries beyond one fp16 ulp of float64 sums {beyond}, beyond it and the "
                  f"float32 sums' own error {off}", flush=True)
            check(dfv16.dtype == h and torch.equal(dfv16, ordered16),
                  f"table_gather_bwd fp16 at N={n_q} differs from the ordered plain sum")
            check(same16 == 10 and off == 0, f"table_gather_bwd fp16 at N={n_q}: run to run "
                  f"or beyond one ulp")
        # Sums past 65,504 (integers, exact in float32 in any order) and
        # in the subnormals (multiples of 2^-24).
        for what, terms in (("overflow", [30000.0, -30000.0, 4096.0, 1.0]),
                            ("subnormal", [2.0 ** -24, 3 * 2.0 ** -24, -2.0 ** -24])):
            ge = torch.as_tensor(r16.choice(np.float32(terms), (B_SERVE, NP, K ** 3 * C)),
                                 device=dev).to(h)
            dfv_e = table_gather_bwd(vox16[:, :NP].contiguous(), ge, GRID, K)
            want_e = table_gather_bwd_ordered(vox16[:, :NP].contiguous(), ge.float(), GRID, K)
            same = bool(torch.equal(dfv_e, want_e.to(h)))
            special = int((torch.isinf(dfv_e) if what == "overflow"
                           else (dfv_e != 0) & (dfv_e.abs() < 2.0 ** -14)).sum())
            print(f"table_gather_bwd fp16 on sums in float16's {what}: equal to the float32 "
                  f"sums rounded once {same} ({special} {what} entries)", flush=True)
            check(same and special > 0, f"table_gather_bwd fp16: {what} sums")
        err_bwd_half["fp16"] = float((dfv16.float() - table_gather_bwd_plain(
            vox16, g16, GRID, K).float()).abs().max())
        del dfv16, ordered16, exact, g16, ge, dfv_e, want_e

    def serve_bf16(reqs, n_key, clouds, want):
        """Per committed net, "full" and "auto" in bf16: the requests,
        counted; the golden pairs against the JAX bf16 and float32 values;
        "full" against "auto"; off-grid queries exactly 0."""
        n_points = reqs[0][0].shape[1]
        f32_gold = golden if n_points == golden["num_point"] else large
        for net in NETS:
            outs, gold = {}, {}
            for mode in ("full", "auto"):
                model = load_frozen_distance(str(ROOT / net), device=dev, dtype="bfloat16",
                                             fused_gather=mode)
                start_count()
                with torch.no_grad():
                    outs[mode] = [model(a, b) for a, b in reqs]
                launched = read_count()
                print(f"{net} bf16 {mode}: {REQUESTS} requests of {B_SERVE} pairs at "
                      f"np={n_points}, kernel launches {launched}", flush=True)
                check(launched == want[mode], f"{net} bf16 {mode}: unexpected launches")
                for out in outs[mode]:
                    check(out.shape == (B_SERVE,) and bool(torch.isfinite(out).all()),
                          "bf16: non-finite distance or wrong shape")
                    check(float(out.min()) >= 0.0 and float(out.max()) <= 2.0,
                          "bf16: distance outside [0, 2]")
                with torch.no_grad():
                    gold[mode] = model(*clouds).cpu().numpy()
                    a, b = reqs[0]
                    b_off = push_off_grid(b)
                    pred_AB, _ = apply_dpdist(model.params(), model.cfg, a, b_off)
                off_mask = voxel_assign(b_off, GRID)[1] == 0
                check(bool((pred_AB[off_mask] == 0).all()), f"bf16 {mode}: off-grid queries "
                      f"not exactly 0")
                err_g = float(np.abs(gold[mode] - np.asarray(golden["bf16"][mode][n_key][net]))
                              .max())
                err_f32 = float(np.abs(gold[mode] - np.asarray(f32_gold["distance"][net])).max())
                print(f"{net} bf16 {mode} at np={n_points}: vs JAX golden bf16 max |d| = "
                      f"{err_g:.3e} (tol {TOL_BF16}); vs float32 golden max |d| = {err_f32:.3e} "
                      f"(tol {TOL_BF16_VS_F32}); {int(off_mask.sum())} off-grid queries "
                      f"exactly 0", flush=True)
                check(err_g <= TOL_BF16, f"{net} bf16 {mode}: vs golden {err_g}")
                check(err_f32 <= TOL_BF16_VS_F32, f"{net} bf16 {mode}: vs float32 {err_f32}")
            err_fc = max(float((f - c).abs().max()) for f, c in zip(outs["full"], outs["auto"]))
            print(f"{net} bf16 at np={n_points}: full vs auto max |d| = {err_fc:.3e} (tol "
                  f"{TOL_BF16})", flush=True)
            check(err_fc <= TOL_BF16, f"{net}: bf16 full vs auto {err_fc}")

    with Phase("serving_bf16"):
        serve_bf16(requests, "np64", (gA, gB),
                   {"full": expected(fused_forward=REQUESTS),
                    "auto": expected(mfv_gather_x=REQUESTS)})
        serve_bf16(requests_large, "np256", (gA_large, gB_large),
                   {"full": expected(threedmfv=2 * REQUESTS, fused_forward=REQUESTS),
                    "auto": expected(threedmfv=2 * REQUESTS, table_gather=2 * REQUESTS)})

    with Phase("serving_on"):
        for reqs, section, clouds, enc in ((requests, golden, (gA, gB), 0),
                                           (requests_large, large, (gA_large, gB_large),
                                            2 * REQUESTS)):
            for net in NETS:
                model = load_frozen_distance(str(ROOT / net), device=dev, fused_gather="on")
                plain = load_frozen_distance(str(ROOT / net), device=dev, fused_gather="off")
                start_count()
                with torch.no_grad():
                    outs = [model(a, b) for a, b in reqs]
                launched = read_count()
                print(f"{net} on: {REQUESTS} requests at np={reqs[0][0].shape[1]}, kernel "
                      f"launches {launched}", flush=True)
                check(launched == expected(gather_patches_fused=2 * REQUESTS, threedmfv=enc),
                      f"{net} on: unexpected launches")
                with torch.no_grad():
                    err_plain = max(float((o - plain(a, b)).abs().max())
                                    for o, (a, b) in zip(outs, reqs))
                    got_golden = model(*clouds).cpu().numpy()
                err_golden = float(np.abs(got_golden - np.asarray(section["distance"][net])).max())
                print(f"{net} on: vs plain path max |d| = {err_plain:.3e}; vs JAX golden max "
                      f"|d| = {err_golden:.3e} (tol {TOL_DIST})", flush=True)
                check(err_plain <= TOL_DIST and err_golden <= TOL_DIST, f"{net} on: distances")

    with Phase("frozen_grad_on"):
        frozen_grad(requests, golden, (gA, gB),
                    expected(gather_patches_fused=2 * REQUESTS, table_gather_bwd=REQUESTS), 0,
                    ("table",), mode="on")
        frozen_grad(requests_large, large, (gA_large, gB_large),
                    expected(threedmfv=2 * REQUESTS, gather_patches_fused=2 * REQUESTS,
                             table_gather_bwd=REQUESTS), REQUESTS, ("table",), mode="on")

    with Phase("route_limits"):
        # Configs past the fused kernels' limits, which the route sends
        # elsewhere: the committed decoder at embedding_size=1000 (the mfv
        # kernel takes at most 992 Gaussians; the decoder's input is
        # 3 + k^3 * 20 wide whatever the grid), f32 and bf16 "auto" and bf16
        # "full", and a bf16 "full" net with hidden widths 40 (the fused
        # forward takes multiples of 16). Each serves the first np = 64
        # request through the route's kernels and matches the plain path.
        a, b = requests[0]
        cfg40 = DPDistConfig(mlp=(40, 40, 40))
        params40, _ = init_dpdist(cfg40, generator=torch.Generator().manual_seed(40), device=dev)

        def at_1000(over):
            return load_frozen_distance(str(ROOT / NETS[0]), device=dev, embedding_size=1000,
                                        **over)

        def net_40(over):
            return FrozenDistance(cfg40.replace(**over), params40).eval()

        bf16_full = {"dtype": "bfloat16", "fused_gather": "full"}
        for what, make, over, want, tol in (
                ("embedding_size=1000, f32", at_1000, {}, expected(table_gather_x=2), TOL_DIST),
                ("embedding_size=1000, bf16 auto", at_1000, {"dtype": "bfloat16"},
                 expected(table_gather_x=2), TOL_BF16),
                ("embedding_size=1000, bf16 full", at_1000, bf16_full,
                 expected(fused_forward=1), TOL_BF16),
                ("mlp=(40, 40, 40), bf16 full", net_40, bf16_full, expected(table_gather_x=2),
                 TOL_BF16)):
            model, plain = make(over), make({**over, "fused_gather": "off"})
            start_count()
            with torch.no_grad():
                d = model(a, b)
            launched = read_count()
            with torch.no_grad():
                err = float((d - plain(a, b)).abs().max())
            print(f"{what}: route {route_of(model.cfg, 'cuda', NP, NP)}, kernel launches "
                  f"{ {k: v for k, v in launched.items() if v} }; vs plain path max |d| = "
                  f"{err:.3e} (tol {tol})", flush=True)
            check(launched == want, f"{what}: unexpected launches")
            check(d.shape == (B_SERVE,) and bool(torch.isfinite(d).all()), f"{what}: output")
            check(err <= tol, f"{what}: kernel path vs plain path {err}")
        del model, plain, params40

    def frozen_grad_half(dtype, reqs, n_key, clouds, want, replays):
        """Per committed net in `dtype` ("bfloat16" or "float16"): the frozen
        loss and d/dpcA on the golden pairs against JAX's values in that
        dtype; source-gradient calls on the requests, counted, against the
        port's plain path in that dtype; at np = 64 "mfv" and "on" once
        each; "full" refused in bf16 (the reference refuses its gradient)
        and the table path in fp16 (the reference resolves it so); the
        parameters unchanged and without .grad."""
        lab = {"bfloat16": "bf16", "float16": "fp16"}[dtype]
        tol_loss = TOL_BF16_LOSS if dtype == "bfloat16" else TOL_FP16
        gold = golden[f"{lab}_grad"][n_key]
        rows = gold["grad_pairs"]
        for net in NETS:
            cfg, np_params, _ = load_dpdist_checkpoint(str(ROOT / net))
            cfg = cfg.replace(dtype=dtype)
            params = params_from_jax(np_params, dev)
            leaves = [t.requires_grad_(True) for lp in params["decoder"]["layers"]
                      for t in lp.values()]
            before = [t.detach().clone() for t in leaves]
            loss_fn = make_frozen_dpdist_loss(params, cfg,
                                              out_of_grid_penalty=gold["out_of_grid_penalty"])
            value, g = src_grad(loss_fn, *clouds)
            err_value = abs(float(value) - gold[net]["value"])
            worst, share, cos = close_bf16_grads(
                g[rows], torch.as_tensor(gold[net]["grad_pcA"], device=dev),
                f"{net}: golden {lab} d/dpcA")
            print(f"{net} {lab}: golden frozen loss at {n_key} |d| = {err_value:.3e} (tol "
                  f"{tol_loss}); d/dpcA worst point {worst:.3e} of max, share above "
                  f"{REL_BF16} {share:.3f}, cosine {cos:.6f}", flush=True)
            check(err_value <= tol_loss, f"{net}: golden {lab} frozen loss off by {err_value}")
            start_count()
            outs = [src_grad(loss_fn, a, b) for a, b in reqs]
            launched = read_count()
            print(f"{net} {lab}: {REQUESTS} source-gradient calls of {B_SERVE} pairs at "
                  f"{n_key}, kernel launches {launched}, encode replays "
                  f"{threedmfv_kernel.replays}", flush=True)
            check(launched == want, f"{net} {lab}: unexpected launches")
            check(threedmfv_kernel.replays == replays, f"{net} {lab}: unexpected encode replays")
            plain = make_frozen_dpdist_loss(params, cfg.replace(fused_gather="off"))
            for (v, g), (a, b) in zip(outs, reqs):
                check(bool(torch.isfinite(g).all()), f"{lab}: non-finite gradient")
                v_ref, g_ref = src_grad(plain, a, b)
                d = abs(float(v - v_ref))
                worst, share, cos = close_bf16_grads(g, g_ref, f"{net}: {lab} table vs off path")
                check(d <= tol_loss, f"{net}: {lab} loss, table vs off path: {d}")
            print(f"{net} {lab} table path vs off path: loss |d| = {d:.3e}, d/dpcA worst point "
                  f"{worst:.3e} of max, share above {REL_BF16} {share:.3f}, cosine {cos:.6f} "
                  f"(last request)", flush=True)
            a, b = reqs[0]
            v_ref, g_ref = src_grad(plain, a, b)
            for mode in (("mfv", "on") if n_key == "np64" else ()):
                other = make_frozen_dpdist_loss(params, cfg.replace(fused_gather=mode))
                v, g = src_grad(other, a, b)
                worst, share, cos = close_bf16_grads(g, g_ref, f"{net}: {lab} {mode} vs off path")
                d = abs(float(v - v_ref))
                check(d <= tol_loss, f"{net}: {lab} loss, {mode} vs off path: {d}")
                print(f"{net} {lab} {mode} path vs off path: loss |d| = {d:.3e}, d/dpcA worst "
                      f"point {worst:.3e} of max, cosine {cos:.6f}", flush=True)
            full = make_frozen_dpdist_loss(params, cfg.replace(fused_gather="full"))
            if dtype == "bfloat16":
                try:
                    src_grad(full, a, b)
                    refused = False
                except NotImplementedError as e:
                    refused = "refuses" in str(e)
                check(refused, f"{net}: bf16 full under autograd was not refused")
            else:
                v, g = src_grad(full, a, b)
                close_bf16_grads(g, g_ref, f"{net}: fp16 full (the table path) vs off path")
                check(abs(float(v - v_ref)) <= tol_loss, f"{net}: fp16 full loss vs off path")
            check(all(t.grad is None for t in leaves), f"{net}: a parameter received .grad")
            check(all(torch.equal(t, b_) for t, b_ in zip(leaves, before)),
                  f"{net}: a parameter changed")

    with Phase("frozen_grad_bf16"):
        frozen_grad_half("bfloat16", requests, "np64", (gA, gB),
                         expected(table_gather_x=2 * REQUESTS, table_gather_bwd_bf16=REQUESTS), 0)
        frozen_grad_half("bfloat16", requests_large, "np256", (gA_large, gB_large),
                         expected(threedmfv=2 * REQUESTS, table_gather=2 * REQUESTS,
                                  table_gather_bwd_bf16=REQUESTS), REQUESTS)

    with Phase("train_bf16"), tempfile.TemporaryDirectory() as tmp:
        mcfg16 = DPDistConfig(dtype="bfloat16")
        trainer16 = DPDistTrainer(mcfg16, tcfg, run_dir=os.path.join(tmp, "run"), device=dev,
                                  logger=RunLogger(os.path.join(tmp, "run"), echo=False))
        start_count()
        losses16 = [trainer16.train_step(data, labels)["loss"] for _ in range(TRAIN_STEPS)]
        launched = read_count()
        losses16 = torch.stack(losses16).cpu().numpy()
        print(f"train bf16: {TRAIN_STEPS} steps at B={B_TRAIN}, kernel launches {launched}; loss "
              f"{losses16[0]:.5f} -> {losses16[-1]:.5f} (first 5 mean {losses16[:5].mean():.5f}, "
              f"last 5 mean {losses16[-5:].mean():.5f})", flush=True)
        check(launched == expected(table_gather_x=TRAIN_STEPS), "train bf16: unexpected launches")
        check(bool(np.isfinite(losses16).all()), "train bf16: non-finite loss")
        check(losses16[-5:].mean() < losses16[:5].mean(), "train bf16: the loss did not fall")
        check(all(t.dtype == torch.float32 for lp in trainer16.params["decoder"]["layers"]
                  for t in lp.values()), "train bf16: the master weights are not float32")
        # One step on the kernel path against the plain bf16 path, same params.
        batch16 = trainer16.make_batch(data, labels)
        plain16 = DPDistTrainer(mcfg16.replace(fused_gather="off"), tcfg,
                                run_dir=os.path.join(tmp, "off"), device=dev,
                                logger=RunLogger(os.path.join(tmp, "off"), echo=False))
        plain16._set_params(trainer16.params)
        (l_k, g_k), (l_p, g_p) = (t.loss_and_grads(*batch16) for t in (trainer16, plain16))
        err_g = max(float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(g_k, g_p))
        print(f"train bf16 step, kernel path vs plain path: loss |d| = {float(l_k - l_p):.3e}, "
              f"grads worst {err_g:.3e} of max", flush=True)
        check(abs(float(l_k - l_p)) <= TOL_BF16_LOSS and err_g <= 2e-2,
              "train bf16 step: kernel path and plain path disagree")
        # The first profile of a whole train step (train/profiling.py).
        from dpdist_tpu_torch.train.profiling import trace

        with trace(os.path.join(tmp, "trace")) as prof:
            trainer16.train_step(data, labels)
        top = sorted((e for e in prof.key_averages() if e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)[:6]
        check(os.path.isfile(os.path.join(tmp, "trace", "trace.json")), "trace.json missing")
        print("train bf16 step, torch.profiler device time by kernel: " + "; ".join(
            f"{e.key[:48]} {e.self_device_time_total:.1f} us" for e in top) + f"; on {card}",
              flush=True)
        del trainer16, plain16, batch16

    with Phase("serving_fp16"):
        # The float16 distance served per committed net: "auto" at np = 64
        # (row 1) and 256 (rows 7 and 6), "full" at 64, which is the table
        # path in float16 (row 2), and "on" at 64 (row 10 on the volume
        # rounded to float16); the golden pairs against the JAX fp16 values
        # and against float32, the requests against the port's plain fp16
        # path, off-grid queries exactly 0.
        r16 = np.random.default_rng(17)
        for reqs, n_key, clouds, f32_gold, modes in (
                (requests, "np64", (gA, gB), golden,
                 {"auto": expected(mfv_gather_x=REQUESTS),
                  "full": expected(table_gather_x=2 * REQUESTS),
                  "on": expected(gather_patches_fused=2 * REQUESTS)}),
                (requests_large, "np256", (gA_large, gB_large), large,
                 {"auto": expected(threedmfv=2 * REQUESTS, table_gather=2 * REQUESTS)})):
            for net in NETS:
                plain = load_frozen_distance(str(ROOT / net), device=dev, dtype="float16",
                                             fused_gather="off")
                for mode, want in modes.items():
                    model = load_frozen_distance(str(ROOT / net), device=dev, dtype="float16",
                                                 fused_gather=mode)
                    start_count()
                    with torch.no_grad():
                        outs = [model(a, b) for a, b in reqs]
                    launched = read_count()
                    check(launched == want, f"{net} fp16 {mode} at {n_key}: launches {launched}")
                    with torch.no_grad():
                        err_plain = max(float((o - plain(a, b)).abs().max())
                                        for o, (a, b) in zip(outs, reqs))
                        got_golden = model(*clouds).cpu().numpy()
                        a, b = reqs[0]
                        b_off = b.clone()
                        far = torch.as_tensor(r16.random(b.shape[:2]) < OFF_GRID_SHARE, device=dev)
                        far[:, 0] = True
                        b_off[far] = FAR
                        pred_AB, _ = apply_dpdist(model.params(), model.cfg, a, b_off)
                    check(all(o.shape == (B_SERVE,) and bool(torch.isfinite(o).all())
                              and float(o.min()) >= 0.0 and float(o.max()) <= 2.0 for o in outs),
                          f"{net} fp16 {mode}: a distance non-finite or outside [0, 2]")
                    check(bool((pred_AB[far] == 0).all()), f"{net} fp16 {mode}: off-grid "
                          f"queries not exactly 0")
                    err_g = float(np.abs(got_golden - np.asarray(golden["fp16"]["table"][n_key][net]))
                                  .max())
                    err_f32 = float(np.abs(got_golden - np.asarray(f32_gold["distance"][net])).max())
                    print(f"{net} fp16 {mode} at {n_key}: {REQUESTS} requests of {B_SERVE} pairs, "
                          f"launches { {k: v for k, v in launched.items() if v} }; vs the plain "
                          f"fp16 path max |d| {err_plain:.3e}, vs JAX golden fp16 {err_g:.3e} "
                          f"(tol {TOL_FP16}), vs float32 golden {err_f32:.3e} (tol "
                          f"{TOL_FP16_VS_F32}); {int(far.sum())} off-grid queries exactly 0",
                          flush=True)
                    check(err_plain <= TOL_FP16 and err_g <= TOL_FP16,
                          f"{net} fp16 {mode}: off the plain path or the golden values")
                    check(err_f32 <= TOL_FP16_VS_F32, f"{net} fp16 {mode}: off float32")
        del model, plain

    with Phase("frozen_grad_fp16"):
        frozen_grad_half("float16", requests, "np64", (gA, gB),
                         expected(table_gather_x=2 * REQUESTS, table_gather_bwd_fp16=REQUESTS), 0)
        frozen_grad_half("float16", requests_large, "np256", (gA_large, gB_large),
                         expected(threedmfv=2 * REQUESTS, table_gather=2 * REQUESTS,
                                  table_gather_bwd_fp16=REQUESTS), REQUESTS)

    with Phase("train_fp16"), tempfile.TemporaryDirectory() as tmp:
        # TRAIN_STEPS float16 steps at B_TRAIN (float32 master weights, a
        # float16 decoder, no loss scaling, as the reference's): one row-2
        # launch a step, the loss falls; one step against the plain fp16
        # path from the same params.
        mcfg_h = DPDistConfig(dtype="float16")
        trainer_h = DPDistTrainer(mcfg_h, tcfg, run_dir=os.path.join(tmp, "run"), device=dev,
                                  logger=RunLogger(os.path.join(tmp, "run"), echo=False))
        start_count()
        losses_h = [trainer_h.train_step(data, labels)["loss"] for _ in range(TRAIN_STEPS)]
        launched = read_count()
        losses_h = torch.stack(losses_h).cpu().numpy()
        print(f"train fp16: {TRAIN_STEPS} steps at B={B_TRAIN}, kernel launches "
              f"{ {k: v for k, v in launched.items() if v} }; loss {losses_h[0]:.5f} -> "
              f"{losses_h[-1]:.5f} (first 5 mean {losses_h[:5].mean():.5f}, last 5 mean "
              f"{losses_h[-5:].mean():.5f})", flush=True)
        check(launched == expected(table_gather_x=TRAIN_STEPS), "train fp16: unexpected launches")
        check(bool(np.isfinite(losses_h).all()), "train fp16: non-finite loss")
        check(losses_h[-5:].mean() < losses_h[:5].mean(), "train fp16: the loss did not fall")
        check(all(t.dtype == torch.float32 for lp in trainer_h.params["decoder"]["layers"]
                  for t in lp.values()), "train fp16: the master weights are not float32")
        batch_h = trainer_h.make_batch(data, labels)
        plain_h = DPDistTrainer(mcfg_h.replace(fused_gather="off"), tcfg,
                                run_dir=os.path.join(tmp, "off"), device=dev,
                                logger=RunLogger(os.path.join(tmp, "off"), echo=False))
        plain_h._set_params(trainer_h.params)
        (l_k, g_k), (l_p, g_p) = (t.loss_and_grads(*batch_h) for t in (trainer_h, plain_h))
        err_g = max(float((a_ - b_).abs().max()) / float(b_.abs().max()) for a_, b_ in zip(g_k, g_p))
        print(f"train fp16 step, kernel path vs plain path: loss |d| = {float(l_k - l_p):.3e}, "
              f"grads worst {err_g:.3e} of max", flush=True)
        check(abs(float(l_k - l_p)) <= TOL_FP16 and err_g <= 2e-2,
              "train fp16 step: kernel path and plain path disagree")
        del trainer_h, plain_h, batch_h

    with Phase("gtgen_kernel"):
        # Row 8 as the ground-truth generator calls it: one round of
        # candidates against a dense surface, then a square root; against
        # the native host library.
        rg = np.random.default_rng(41)
        gt_surface = (synthetic_surface("chair", seed=41, n_points=GT_SURFACE) * 0.8).astype(np.float32)
        gt_cand = np.ascontiguousarray(gtgen.uniform_sampling(rg, GT_CANDIDATES), np.float32)
        d_card = gtgen.min_distances(gt_cand, gt_surface, device=dev)
        t0 = time.perf_counter()
        d_native = native_lib.min_distances_native(gt_cand, gt_surface)
        native_s = time.perf_counter() - t0
        # Row 8's tolerance on the squares, taken through the square root.
        gt_bound = (TOL_NN_ABS + TOL_NN_REL * d_native ** 2) / np.maximum(d_card + d_native, 1e-3)
        gt_bad = int((np.abs(d_card - d_native) > gt_bound + 1e-7).sum())
        print(f"gtgen min_distances on the card ({GT_CANDIDATES} x {GT_SURFACE}) vs the native "
              f"library: max |d| = {float(np.abs(d_card - d_native).max()):.3e}, outside row 8's "
              f"tolerance {gt_bad}, bit-equal share {float(np.mean(d_card == d_native)):.4f}; "
              f"native {native_s * 1e3:.1f} ms on {os.cpu_count()} host cores", flush=True)
        check(gt_bad == 0, f"gtgen min_distances: {gt_bad} distances outside tolerance")
        # One model generated on the card and on the CPU from one seed.
        dense = synthetic_surface("box", seed=42, n_points=GT_SURFACE)
        t0 = time.perf_counter()
        s_c, near_c, far_c = gtgen.generate_gt_for_points(
            dense, num_neg_points=GT_NEG, rng=np.random.default_rng(43), device=dev)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        s_h, near_h, far_h = gtgen.generate_gt_for_points(
            dense, num_neg_points=GT_NEG, rng=np.random.default_rng(43), device="cpu")
        host_s = time.perf_counter() - t0
        same = {k_: float(np.mean(np.all(x == y, axis=1))) for k_, x, y in
                (("near", near_c, near_h), ("far", far_c, far_h))}
        check(np.array_equal(s_c, s_h) and near_c.shape == near_h.shape == (GT_NEG, 4)
              and far_c.shape == far_h.shape == (GT_NEG, 4), "gtgen: row counts differ")
        # Every row's distance on the card against the native distance of its point.
        redo = native_lib.min_distances_native(np.concatenate([near_c, far_c])[:, :3], s_c)
        d_rows = np.concatenate([near_c, far_c])[:, 3]
        tol_rows = (TOL_NN_ABS + TOL_NN_REL * redo ** 2) / np.maximum(d_rows + redo, 1e-3) + 1e-7
        row_bad = int((np.abs(d_rows - redo) > tol_rows).sum())
        # Each card row obeys the selection rule by its native distance, up
        # to row 8's tolerance: near rows min_eps < d < 2 eps, far rows
        # d > 2 eps, the far set's last 10 % cube points outside the unit sphere.
        n_out = GT_NEG // 10
        dn_near, dn_far = redo[:GT_NEG], redo[GT_NEG:GT_NEG + GT_NEG - n_out]
        t_near, t_far = tol_rows[:GT_NEG], tol_rows[GT_NEG:GT_NEG + GT_NEG - n_out]
        rule_bad = int(((dn_near <= GT_MIN_EPS - t_near) | (dn_near >= 2 * GT_EPS + t_near)).sum()
                       + (dn_far <= 2 * GT_EPS - t_far).sum()
                       + (np.linalg.norm(far_c[-n_out:, :3], axis=1) <= 1).sum())

        def first_difference(card_rows, host_rows):
            """The first row whose point differs between the card's set and
            the host's, and whether a threshold flip explains it: one of the
            two points has its card and native distances on either side of
            a threshold, so the two runs judged it differently (a row drawn
            in another order would not be one). (None, True) if all agree."""
            diff = np.flatnonzero(np.any(card_rows[:, :3] != host_rows[:, :3], axis=1))
            if not len(diff):
                return None, True
            i0 = int(diff[0])
            pts = np.stack([card_rows[i0, :3], host_rows[i0, :3]])
            dc = gtgen.min_distances(pts, s_c, device=dev)
            dn = native_lib.min_distances_native(pts, s_c)
            return i0, any(bool(np.any((dc - t) * (dn - t) <= 0)) for t in (GT_MIN_EPS, 2 * GT_EPS))

        near_i0, near_flip = first_difference(near_c, near_h)
        far_i0, far_flip = first_difference(far_c[:-n_out], far_h[:-n_out])
        print(f"gtgen model on the card vs the CPU: rows near {len(near_c)} / {len(near_h)}, far "
              f"{len(far_c)} / {len(far_h)}; share of equal rows near {same['near']:.4f}, far "
              f"{same['far']:.4f}; first differing point near {near_i0} (threshold flip "
              f"{near_flip}), far {far_i0} (threshold flip {far_flip}); card rows whose distance "
              f"is off the native one: {row_bad}, outside the selection rule: {rule_bad}; "
              f"{card_s:.2f} s on the card, {host_s:.2f} s on the host", flush=True)
        check(row_bad == 0, f"gtgen: {row_bad} rows with a wrong distance")
        check(rule_bad == 0, f"gtgen: {rule_bad} rows outside the selection rule")
        check(near_flip and far_flip, "gtgen: the card's rows part from the host's at a point "
              "that no threshold flip explains")

    with Phase("train_cli"), tempfile.TemporaryDirectory() as tmp:
        # gen_data on the card, then train_dpdist for 2 epochs in float32 and
        # in bfloat16, then --resume, then the checkpoint served.
        check(native_lib.available() and native_path.is_file(),
              "the native host library is not built on this host")
        root = os.path.join(tmp, "data")
        gen_args = ["--out", root, "--families", "chair", "box", "--n_train", str(GT_TRAIN // 2),
                    "--n_test", str(GT_TEST // 2), "--n_surface", str(GT_SURFACE),
                    "--num_neg_points", str(GT_NEG), "--device", "cuda"]
        start_count()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            gen_data_cli.main(gen_args)
        gen_s = time.perf_counter() - t0
        launched = read_count()
        n_models = GT_TRAIN + GT_TEST
        print(f"gen_data --device cuda: {n_models} models at n_surface {GT_SURFACE}, "
              f"{GT_NEG} near and far points, in {gen_s:.2f} s; kernel launches "
              f"{ {k_: v for k_, v in launched.items() if v} }", flush=True)
        check(launched["nn_min_sqdist"] >= 2 * n_models
              and sum(launched.values()) == launched["nn_min_sqdist"], "gen_data: launches")
        steps = GT_TRAIN // CLI_BATCH
        for dtype in ("float32", "bfloat16"):
            log_dir = os.path.join(tmp, dtype)
            args = ["--data_root", root, "--category", "all", "--log_dir", log_dir,
                    "--batch_size", str(CLI_BATCH), "--eval_every", "1", "--dtype", dtype,
                    "--device", "cuda"]
            start_count()
            with contextlib.redirect_stdout(io.StringIO()):
                t0 = time.perf_counter()
                cli_trainer = train_dpdist_cli.main(args + ["--max_epoch", "2"])
                torch.cuda.synchronize()
                train_s = time.perf_counter() - t0
            launched = read_count()
            metrics = [json.loads(line) for line in open(os.path.join(log_dir, "metrics.jsonl"))]
            train_losses = [m["train_loss"] for m in metrics if "train_loss" in m]
            eval_losses = [m["eval_loss"] for m in metrics if "eval_loss" in m]
            print(f"train_dpdist {dtype}: 2 epochs of {steps} steps at B={CLI_BATCH} in "
                  f"{train_s:.2f} s, train loss {train_losses}, eval loss {eval_losses}; kernel "
                  f"launches { {k_: v for k_, v in launched.items() if v} }", flush=True)
            check(cli_trainer.global_step == 2 * steps and len(train_losses) == 2
                  and bool(np.isfinite(train_losses + eval_losses).all()),
                  f"train_dpdist {dtype}: steps or losses")
            check(launched == expected(table_gather_x=2 * steps, mfv_gather_x=2),
                  f"train_dpdist {dtype}: unexpected launches")
            with contextlib.redirect_stdout(io.StringIO()):
                resumed = train_dpdist_cli.main(args + ["--resume", "--max_epoch", "1"])
            check(resumed.global_step == 3 * steps, f"train_dpdist {dtype} --resume: step "
                  f"{resumed.global_step}")
            from dpdist_tpu_torch.train import latest_checkpoint

            ckpt = latest_checkpoint(log_dir)
            served = load_frozen_distance(ckpt, device=dev)
            with torch.no_grad():
                d = served(*requests[0])
            print(f"train_dpdist {dtype} --resume: step {resumed.global_step}; {os.path.basename(ckpt)}"
                  f" served by load_frozen_distance ({served.cfg.dtype}): distances "
                  f"{float(d.min()):.4f}..{float(d.max()):.4f}", flush=True)
            check(served.cfg.dtype == dtype and d.shape == (B_SERVE,)
                  and bool(torch.isfinite(d).all()) and float(d.min()) >= 0.0
                  and float(d.max()) <= 2.0, f"train_dpdist {dtype}: the checkpoint's distances")
        del cli_trainer, resumed, served

    reg_golden = json.loads((ROOT / REG_GOLDEN).read_text())
    pcfg, policy_np = load_pcrnet_checkpoint(str(ROOT / POLICY))

    def production_cases():
        return RegistrationDataset(pose_file=default_eval_poses(), num_point=pcfg.num_point,
                                   **REG_MF)

    def buckets(r):
        """A report's accuracy buckets, plain and symmetry-aware, flat."""
        out = {k: v for k, v in r.items() if k.startswith(("acc_", "sym_acc_"))}
        out.update(r.get("sym_acc", {}))
        return out

    with Phase("registration_eval"):
        # The production policy on all 5,070 poses, 50 iterations, the period0
        # stop. It launches no kernel: dense layers and 4x4 pose algebra.
        start_count()
        t0 = time.perf_counter()
        report = registration.evaluate_registration(
            policy_np, pcfg, production_cases(), num_cases=REG_CASES, iterations=REG_ITERATIONS,
            batch_size=REG_BATCH, device=dev, **REG_STOP)
        reg_s = time.perf_counter() - t0
        launched = read_count()
        check(sum(launched.values()) == 0, f"registration_eval launched kernels: {launched}")
        gold, archived = reg_golden["report"], reg_golden["archived"]["tpu_buckets"]
        worst = 0.0
        for scope in ("all",) + REG_FAMILIES:
            got = buckets(report if scope == "all" else report["per_family"][scope])
            want = buckets(gold if scope == "all" else gold["per_family"][scope])
            check(set(got) == set(want), f"registration_eval {scope}: bucket keys differ")
            d = max(abs(got[k] - want[k]) for k in want)
            worst = max(worst, d)
            print(f"registration_eval {scope}: acc@(2.5, 0.05) {got['acc_rot2.5_trans0.05']:.4f} "
                  f"(JAX {want['acc_rot2.5_trans0.05']:.4f}; archived TPU run of the best "
                  f"checkpoint {archived[scope]['acc_rot2.5_trans0.05']:.4f}), acc@(5, 0.05) "
                  f"{got['acc_rot5.0_trans0.05']:.4f} (JAX {want['acc_rot5.0_trans0.05']:.4f}), "
                  f"worst bucket |d| {d:.4f}", flush=True)
        d_conv = abs(report["converged_frac"] - gold["converged_frac"])
        reg_cps = 1.0 / report["time_per_case_s"]
        print(f"registration_eval: {REG_CASES} cases x {REG_ITERATIONS} iterations, period0 stop, "
              f"batches of {REG_BATCH}: rot err mean {report['rot_err_mean_deg']:.3f} deg (JAX "
              f"{gold['rot_err_mean_deg']:.3f}), converged {report['converged_frac']:.4f} (JAX "
              f"{gold['converged_frac']:.4f}); worst bucket |d| {worst:.4f} (tol {TOL_BUCKET}); "
              f"{reg_s:.2f} s end to end (host clock, data included), {reg_cps:.1f} cases/s "
              f"(batches after the first); kernel launches 0; on {card}", flush=True)
        check(worst <= TOL_BUCKET and d_conv <= TOL_BUCKET,
              f"registration_eval: buckets off the golden JAX report by {worst}, "
              f"converged_frac by {d_conv}")
        wide = registration.evaluate_registration(
            policy_np, pcfg, production_cases(), num_cases=REG_CASES, iterations=REG_ITERATIONS,
            batch_size=REG_CASES // 5, device=dev, **REG_STOP)
        print(f"registration_eval at batches of {REG_CASES // 5}: "
              f"{1.0 / wide['time_per_case_s']:.1f} cases/s (batches after the first); the "
              f"dataset's draws depend on the batch, so these cases are not the protocol's; "
              f"on {card}", flush=True)

        # The first 256 cases per case, at 8 and 50 iterations.
        policy = params_to_device(policy_np, dev)
        ds = production_cases()
        per_case = {8: ([], []), 50: ([], [])}
        for _ in range(REG_PER_CASE // REG_BATCH):
            cases = [torch.as_tensor(a, device=dev) for a in ds.sample_batch(REG_BATCH)]
            for its, (rot, trans) in per_case.items():
                _, te, re, *_ = registration._eval_program(policy, pcfg, *cases, its,
                                                           **REG_STOP)
                rot.append(re[-1].cpu().numpy())
                trans.append(te[-1].cpu().numpy())
        for its, (rot, trans) in per_case.items():
            g = reg_golden["per_case"][str(its)]
            d_rot = np.abs(np.concatenate(rot) - np.asarray(g["rot"]))
            d_trans = np.abs(np.concatenate(trans) - np.asarray(g["trans"]))
            outside = float(np.mean((d_rot > TOL_ROT) | (d_trans > TOL_TRANS)))
            print(f"registration_eval per case, first {REG_PER_CASE} at {its} iterations vs JAX: "
                  f"worst rot {d_rot.max():.4f} deg, trans {d_trans.max():.3e}; outside "
                  f"({TOL_ROT} deg, {TOL_TRANS}) {outside:.4f}; parted by > 1 deg "
                  f"{int((d_rot > 1.0).sum())}", flush=True)
            if its == 8:
                check(outside <= OUTLIERS and d_rot.max() <= TOL_ROT_FEW
                      and d_trans.max() <= TOL_TRANS_FEW,
                      "registration_eval: per-case errors at 8 iterations off JAX's")
        del policy, wide

    with Phase("train_pcrnet"), tempfile.TemporaryDirectory() as tmp:
        # The production recipe on the frozen DPDist loss (the second
        # committed net): every step launches row 2 twice (both directions'
        # forward) and row 3 once (the source's adjoint), full BPTT included:
        # the 8 iterations go through one loss call.
        dpdist_net = load_dpdist_checkpoint(str(ROOT / NETS[1]))
        ptcfg = TrainConfig(batch_size=PCR_BATCH, grad_clip=1.0)
        recipe = RegistrationDataset(num_point=pcfg.num_point, **REG_RECIPE)
        tmpl, src, pose6 = recipe.sample_batch(PCR_BATCH, random_points_prob=1.0, noise_prob=1.0)
        per_step = expected(table_gather_x=2, table_gather_bwd=1)

        def pcr_trainer(name, mode=None, mesh=None):
            cfg_, params_, state_ = dpdist_net
            d = os.path.join(tmp, name)
            return PCRNetTrainer(pcfg, ptcfg, loss_type="dpdist", train_single=True,
                                 dpdist=(cfg_.replace(fused_gather=mode) if mode else cfg_,
                                         params_, state_),
                                 run_dir=d, mesh=mesh, device=dev,
                                 logger=RunLogger(d, echo=False))

        resumed = pcr_trainer("resumed")
        resumed.restore(str(ROOT / POLICY))
        start_count()
        m = resumed.train_step(tmpl, src, pose6)
        launched = read_count()
        gs = reg_golden["train_step"]["resumed"]
        err = abs(float(m["loss"]) - gs["loss"]) / gs["loss"]
        err_gn = abs(float(m["grad_norm"]) - gs["grad_norm"]) / gs["grad_norm"]
        print(f"train_pcrnet: first step resumed from {POLICY}, B={PCR_BATCH}: loss "
              f"{float(m['loss']):.6f} (JAX {gs['loss']:.6f}, rel |d| {err:.2e}, tol "
              f"{TOL_PCR_LOSS}), grad norm {float(m['grad_norm']):.5f} (JAX "
              f"{gs['grad_norm']:.5f}, rel |d| {err_gn:.2e}); kernel launches {launched}",
              flush=True)
        check(launched == per_step, "train_pcrnet: unexpected launches")
        check(err <= TOL_PCR_LOSS, "train_pcrnet: the resumed step's loss is off the golden one")

        scratch = pcr_trainer("scratch")
        losses = []
        for _ in range(PCR_STEPS):
            start_count()
            losses.append(scratch.train_step(tmpl, src, pose6)["loss"])
            check(read_count() == per_step, "train_pcrnet: unexpected launches in a step")
        losses = torch.stack(losses).cpu().numpy()
        print(f"train_pcrnet: {PCR_STEPS} steps from scratch on one batch, each 2 row-2 and 1 "
              f"row-3 launches; loss {losses[0]:.5f} -> {losses[-1]:.5f} (first 5 mean "
              f"{losses[:5].mean():.5f}, last 5 mean {losses[-5:].mean():.5f})", flush=True)
        check(bool(np.isfinite(losses).all()), "train_pcrnet: non-finite loss")
        check(losses[-5:].mean() < losses[:5].mean(), "train_pcrnet: the loss did not fall")

        # One step's loss and gradients on the kernel path and the plain path.
        plain = pcr_trainer("plain", "off")
        plain.params = params_to_device(scratch.params, dev, requires_grad=True)
        batch_t = [torch.as_tensor(a, device=dev) for a in (tmpl, src)]
        (l_k, g_k), (l_p, g_p) = (t.loss_and_grads(*batch_t) for t in (scratch, plain))
        err_loss = abs(float(l_k - l_p)) / abs(float(l_p))
        err_g = max(float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(g_k, g_p))
        print(f"train_pcrnet step, kernel path vs plain path: loss rel |d| {err_loss:.2e}, "
              f"grads worst {err_g:.2e} of a leaf's largest entry", flush=True)
        check(err_loss <= 1e-5 and err_g <= 1e-4,
              "train_pcrnet step: kernel path and plain path disagree")
        del plain, g_k, g_p

        pcr_step_ms = cuda_median_ms(lambda: resumed.train_step(tmpl, src, pose6))
        print(f"train_pcrnet step (B={PCR_BATCH}, 8 loops, full BPTT): {pcr_step_ms:.3f} ms "
              f"(CUDA-event median of {TIMED_RUNS}); on {card}", flush=True)

        # The CLI for 1 epoch of 4 batches, resumed from the policy, then
        # eval_registration on its checkpoint.
        log_dir = os.path.join(tmp, "cli")
        args = ["--loss_type", "dpdist", "--dpdist_ckpt", str(ROOT / NETS[1]),
                "--num_point", "64", "--max_loops", "8", "--out_features", "1024",
                "--families", *REG_FAMILIES, "--n_templates", "125", "--max_rotate_deg", "45",
                "--sparse", "1", "--s_rand_points", "1.0", "--centroid_sub", "0",
                "--batch_size", str(PCR_BATCH), "--batches_per_epoch", "4",
                "--data_parallel", "1", "--train_single", "--grad_clip", "1.0",
                "--select_family", "chair", "--eval_cases", "160", "--noise_prob", "1.0",
                "--seed", "0", "--max_epoch", "1", "--log_dir", log_dir,
                "--resume", str(ROOT / POLICY), "--device", "cuda"]
        start_count()
        with contextlib.redirect_stdout(io.StringIO()):
            cli_pcr = train_pcrnet_cli.main(args)
        launched = read_count()
        policy_step = json.loads((ROOT / (POLICY + ".json")).read_text())["step"]
        print(f"train_pcrnet CLI: 1 epoch of 4 batches resumed at step {policy_step}, now "
              f"{cli_pcr.global_step}; kernel launches "
              f"{ {k_: v for k_, v in launched.items() if v} }", flush=True)
        check(cli_pcr.global_step == policy_step + 4, "train_pcrnet CLI: steps")
        check(launched == expected(table_gather_x=8, table_gather_bwd=4),
              "train_pcrnet CLI: unexpected launches")
        eval_args = ["--ckpt", os.path.join(log_dir, "pcrnet_ckpt_final"), "--iterations", "8",
                     "--num_cases", str(REG_PER_CASE), "--families", *REG_FAMILIES,
                     "--n_templates", "125", "--sparse", "1", "--s_rand_points", "1.0",
                     "--centroid_sub", "0", "--seed", "777", "--pose_file", "default",
                     "--stop_threshold", "1e-3", "--stop_period", "2", "--stop_select",
                     "period0", "--report_dir", os.path.join(tmp, "eval"), "--device", "cuda"]
        start_count()
        with contextlib.redirect_stdout(io.StringIO()):
            rep = eval_registration_cli.main(eval_args)
        launched = read_count()
        print(f"eval_registration CLI on its checkpoint: {rep['num_cases']} cases x 8 "
              f"iterations, acc@(2.5, 0.05) {rep['acc_rot2.5_trans0.05']:.4f}, chair "
              f"{rep['per_family']['chair']['acc_rot2.5_trans0.05']:.4f}; kernel launches "
              f"{sum(launched.values())}", flush=True)
        check(rep["num_cases"] == REG_PER_CASE and np.isfinite(rep["rot_err_mean_deg"])
              and sum(launched.values()) == 0, "eval_registration CLI")
        del scratch, cli_pcr

    aue_golden = json.loads(AUE_GOLDEN_PATH.read_text())
    aue_data = aue_batch(aue_golden["batch"])
    ax1, ax2 = (torch.as_tensor(a, device=dev) for a in split_same_surface(aue_data))
    aue_net = load_dpdist_checkpoint(str(ROOT / aue_golden["dpdist_net"]))
    aue_tcfg = TrainConfig(batch_size=aue_golden["batch"]["batch_size"],
                           learning_rate=aue_golden["learning_rate"], seed=aue_golden["seed"])
    aue_per_step = {"ours": expected(table_gather_x=2, table_gather_bwd=1), "chamfer": expected()}
    aue_prof = None

    def aue_trainer(encoder, opt_type, d):
        return AUETrainer(AUEConfig(encoder=encoder), aue_tcfg, *aue_net, opt_type=opt_type,
                          run_dir=d, device=dev, logger=RunLogger(d, echo=False))

    with Phase("aue"), tempfile.TemporaryDirectory() as tmp:
        # The AUE trained on the frozen DPDist loss (and on chamfer) at full
        # width, B = 16: weights from the seeded init, rebuilt here; each
        # "ours" step launches row 2 twice and row 3 once.
        for encoder in ("3dmfv", "pn"):
            want = aue_golden["aue"][encoder]
            for opt_type in ("ours", "chamfer"):
                t0 = time.perf_counter()
                tr = aue_trainer(encoder, opt_type, os.path.join(tmp, encoder + opt_type))
                torch.cuda.synchronize()
                init_s = time.perf_counter() - t0
                fp = {p: (float(t.detach().double().sum()), float(t.detach().double().square().sum()))
                      for p, t in tree_flatten_with_paths(tr.params)}
                err_fp = max(abs(a - b) / max(abs(b), 1e-30) for p, v in fp.items()
                             for a, b in zip(v, want["fingerprint"][p]))
                check(err_fp <= TOL_FINGERPRINT, f"aue {encoder}: the seeded weights differ from "
                      f"the golden file's (per-leaf sums {err_fp:.2e} apart)")
                if opt_type == "ours":
                    rec = tr.reconstruct(split_same_surface(aue_data)[0][:len(want["recon"])])
                    err_rec = float(np.abs(rec - np.asarray(want["recon"])).max())
                    start_count()
                    mon = [float(v) for v in tr.monitor(ax1, ax2)]
                    mon_launched = {k: v for k, v in read_count().items() if v}
                    err_mon = max(abs(a - b) / b for a, b in zip(mon, want["monitor"]))
                    print(f"aue {encoder}: {sum(t.numel() for _, t in tree_flatten_with_paths(tr.params))} "
                          f"params, init {init_s:.2f} s; reconstruction of "
                          f"{len(want['recon'])} golden clouds max |d| {err_rec:.3e} (tol "
                          f"{TOL_REC}); monitor (DPDist, chamfer) {mon[0]:.6f}, {mon[1]:.6f}, rel "
                          f"|d| {err_mon:.2e} from JAX; monitor launches {mon_launched}; on "
                          f"{card}", flush=True)
                    check(err_rec <= TOL_REC and err_mon <= TOL_AUE,
                          f"aue {encoder}: reconstruction or monitor off the golden values")
                losses, gnorms = [], []
                for _ in range(AUE_STEPS):
                    start_count()
                    m = tr.train_step(aue_data)
                    launched = read_count()
                    launches["fused_adam"] += fused_adam.launches
                    check(launched == aue_per_step[opt_type] and fused_adam.launches == 1,
                          f"aue {encoder} {opt_type}: step launches {launched}, Adam "
                          f"{fused_adam.launches}")
                    losses.append(float(m["loss"]))
                    gnorms.append(float(m["grad_norm"]))
                gw = want["train_steps"][opt_type]
                err_l = [abs(a - b) / b for a, b in zip(losses, gw["loss"])]
                err_g = abs(gnorms[0] - gw["grad_norm"][0]) / gw["grad_norm"][0]
                print(f"aue {encoder} {opt_type}: {AUE_STEPS} Adam steps at B="
                      f"{aue_tcfg.batch_size}, losses {[f'{v:.6f}' for v in losses]} (JAX "
                      f"{[f'{v:.6f}' for v in gw['loss']]}, rel |d| "
                      f"{[f'{v:.1e}' for v in err_l]}), grad norms "
                      f"{[f'{v:.4f}' for v in gnorms]} (JAX {[f'{v:.4f}' for v in gw['grad_norm']]}); "
                      f"launches a step: row 2 {launched['table_gather_x']}, row 3 "
                      f"{launched['table_gather_bwd']}, Adam {fused_adam.launches}", flush=True)
                check(err_l[0] <= TOL_AUE and max(err_l[1:]) <= TOL_LATER_STEPS
                      and err_g <= TOL_AUE_GNORM[opt_type],
                      f"aue {encoder} {opt_type}: the steps are off the golden ones")
                if (encoder, opt_type) == ("3dmfv", "ours"):
                    # The step's loss and its gradient in the reconstruction
                    # on the kernel path and the plain path
                    # (fused_gather="off"), by the per-point criterion (the
                    # encode's signed sqrt magnifies the adjoint's summation
                    # order on a few points).
                    with torch.no_grad():
                        rec_ = apply_aue(tr.params, tr.state, tr.acfg, ax1, train=True)[0]
                    out_kp = []
                    for mode in (None, "off"):
                        cfg_ = aue_net[0] if mode is None else aue_net[0].replace(fused_gather=mode)
                        loss_fn = make_frozen_dpdist_loss(params_from_jax(aue_net[1], dev), cfg_)
                        r_ = rec_.clone().requires_grad_(True)
                        l_ = loss_fn(r_, ax2)
                        out_kp.append((float(l_), torch.autograd.grad(l_, r_)[0]))
                    (l_k, g_k), (l_p, g_p) = out_kp
                    err_kp = check_grad_rows(g_k, g_p, "aue step: d loss / d reconstruction")
                    print(f"aue 3dmfv ours step, kernel path vs plain path: loss rel |d| "
                          f"{abs(l_k - l_p) / l_p:.2e}, d loss / d reconstruction worst point "
                          f"{err_kp:.2e} of max", flush=True)
                    check(abs(l_k - l_p) <= 1e-5 * l_p, "aue step: kernel path and plain path "
                          "disagree on the loss")
                    del out_kp, g_k, g_p
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                    tr.train_step(aue_data)
                    torch.cuda.synchronize()
                    peak = torch.cuda.max_memory_allocated()
                    aue_ms = cuda_median_ms(lambda: tr.train_step(aue_data), runs=AUE_TIMED_STEPS,
                                            warmup=2)
                    print(f"aue 3dmfv ours step (B={aue_tcfg.batch_size}, np=64, 402.7 M "
                          f"decoder weights, Adam): {aue_ms:.3f} ms (CUDA-event median of "
                          f"{AUE_TIMED_STEPS}), {aue_tcfg.batch_size / aue_ms * 1e3:.1f} clouds/s; "
                          f"max_memory_allocated {peak / 2 ** 30:.2f} GiB ({base / 2 ** 30:.2f} GiB "
                          f"held before the step); on {card}", flush=True)
                    aue_prof = tr
                    aue_shapes = [tuple(t.shape) for _, t in tree_flatten_with_paths(tr.params)]
                else:
                    del tr
                torch.cuda.empty_cache()

    with Phase("train_aue_cli"), tempfile.TemporaryDirectory() as tmp:
        # gen_data on the card (20 small models), then train_aue for the
        # production AUE ("ours") and the pn AUE (chamfer), 1 epoch of one
        # B = 16 step each, and --resume. The frozen loss runs row 2 twice in
        # each monitor (the train epoch's and the eval's) and in the step,
        # whose backward runs row 3 once.
        data_dir = os.path.join(tmp, "data")
        start_count()
        with contextlib.redirect_stdout(io.StringIO()):
            gen_data_cli.main(["--out", data_dir, "--families", "chair", "--n_train", "16",
                               "--n_test", "4", "--n_surface", "1000", "--num_neg_points", "300",
                               "--device", "cuda"])
        gen_launched = {k: v for k, v in read_count().items() if v}
        for encoder, opt_type, want in (("3dmfv", "ours", expected(table_gather_x=6,
                                                                   table_gather_bwd=1)),
                                        ("pn", "chamfer", expected(table_gather_x=4))):
            log_dir = os.path.join(tmp, encoder)
            base = ["--dpdist_ckpt", str(ROOT / NETS[0]), "--encoder_aue", encoder,
                    "--opt_type", opt_type, "--data_root", data_dir, "--category", "chair",
                    "--batch_size", "16", "--data_parallel", "1", "--device", "cuda"]
            args = base + ["--max_epoch_aue", "1", "--log_dir", log_dir]
            start_count()
            with contextlib.redirect_stdout(io.StringIO()):
                cli_aue = train_aue_cli.main(args)
            launched = read_count()
            metrics = [json.loads(l) for l in open(os.path.join(log_dir, "metrics.jsonl"))]
            ev = [m_ for m_ in metrics if "eval_dpdist" in m_][-1]
            print(f"train_aue CLI {encoder} {opt_type}: {cli_aue.global_step} step(s), eval "
                  f"DPDist {ev['eval_dpdist']:.5f}, chamfer {ev['eval_chamfer']:.5f}; kernel "
                  f"launches { {k: v for k, v in launched.items() if v} }", flush=True)
            check(cli_aue.global_step == 1 and launched == want
                  and np.isfinite([ev["eval_dpdist"], ev["eval_chamfer"]]).all(),
                  f"train_aue CLI {encoder}")
            del cli_aue
            if encoder == "3dmfv":
                with contextlib.redirect_stdout(io.StringIO()):
                    resumed_aue = train_aue_cli.main(
                        base + ["--max_epoch_aue", "2", "--start_epoch", "1",
                                "--resume", os.path.join(log_dir, "aue_ckpt_1"),
                                "--log_dir", os.path.join(tmp, "resumed")])
                check(resumed_aue.global_step == 2, "train_aue CLI --resume")
                del resumed_aue
            torch.cuda.empty_cache()
        print(f"gen_data on the card for the AUE data: kernel launches {gen_launched}",
              flush=True)

    with Phase("compare_losses"), tempfile.TemporaryDirectory() as tmp:
        # The CLI at its defaults on the canonical net: every pair scored
        # alone, a pure forward (one fused mfv launch, row 1, per pair).
        start_count()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            report = compare_losses_cli.main(["--dpdist_ckpt", str(ROOT / NETS[0]), "--out",
                                              os.path.join(tmp, "r.json"), "--device", "cuda"])
        cmp_s = time.perf_counter() - t0
        launched = read_count()
        want = aue_golden["compare_losses"]["report"]
        err = {key: max(abs(a - b) for kind in want for a, b in zip(report[kind][key],
                                                                    want[kind][key]))
               for key in ("dpdist", "chamfer", "emd")}
        print(f"compare_losses at its defaults: {len(want)} kinds, {COMPARE_PAIRS} pairs in "
              f"{cmp_s:.2f} s (host clock); max |d| from the golden JAX report: "
              + ", ".join(f"{k} {v:.2e}" for k, v in err.items())
              + f"; kernel launches { {k: v for k, v in launched.items() if v} }; on {card}",
              flush=True)
        check(list(report) == list(want) and err["dpdist"] <= TOL_DIST
              and err["chamfer"] <= TOL_CHAMFER and err["emd"] <= TOL_EMD,
              "compare_losses: the report is off the golden one")
        check(launched == expected(mfv_gather_x=COMPARE_PAIRS), "compare_losses: launches")

    with Phase("emd_blocked"):
        # The blocked Sinkhorn EMD on eval_pair's two 10,000-point clouds
        # (tiles of 1,024: padded), against the dense plan; and at B = 2,
        # N = 2,000, M = 1,500 against the port's CPU run.
        r_emd = np.random.default_rng(5)
        xs = r_emd.normal(size=(2, 2000, 3)).astype(np.float32)
        ys = r_emd.normal(size=(2, 1500, 3)).astype(np.float32)
        got = sinkhorn_emd_blocked(torch.as_tensor(xs, device=dev),
                                   torch.as_tensor(ys, device=dev), tile=512).cpu()
        ref = sinkhorn_emd_blocked(torch.as_tensor(xs), torch.as_tensor(ys), tile=512)
        err_cpu = float(((got - ref).abs() / ref).max())
        blocked = float(sinkhorn_emd_blocked(eA, eB)[0])
        dense = float(sinkhorn_emd(eA, eB, 30, 0.5, 0.01)[0])
        emd_ms = cuda_median_ms(lambda: sinkhorn_emd_blocked(eA, eB), runs=3, warmup=1)
        dense_ms = cuda_median_ms(lambda: sinkhorn_emd(eA, eB, 30, 0.5, 0.01), runs=3, warmup=1)
        print(f"sinkhorn_emd_blocked: vs the CPU at B=2, 2000 x 1500, tile 512: rel |d| "
              f"{err_cpu:.2e} (tol {TOL_EMD_BLOCKED}); at {EVAL_POINTS} x {EVAL_POINTS}: "
              f"{blocked:.6f} (dense plan {dense:.6f}), {emd_ms:.2f} ms (CUDA-event median of "
              f"3; dense plan {dense_ms:.2f} ms); on {card}", flush=True)
        check(err_cpu <= TOL_EMD_BLOCKED, "sinkhorn_emd_blocked: card vs CPU")
        check(np.isfinite(blocked) and abs(blocked - dense) <= 0.03 * dense + 1e-3,
              "sinkhorn_emd_blocked: vs the dense plan")

    with Phase("pcrnet_3dmfv"), tempfile.TemporaryDirectory() as tmp:
        # The 3dmfv PCRNet encoder (six 3D inception blocks, BN state) trained
        # on the frozen DPDist loss: the golden step from the seeded weights.
        g3 = aue_golden["pcrnet_3dmfv"]
        cfg3 = PCRNetConfig.from_json(g3["config"])
        data3 = {**g3["data"], "families": tuple(g3["data"]["families"])}
        tmpl3, src3, _ = RegistrationDataset(num_point=cfg3.num_point, **data3).sample_batch(
            g3["batch_size"])
        tr3 = PCRNetTrainer(cfg3, TrainConfig(batch_size=g3["batch_size"],
                                              learning_rate=g3["learning_rate"]),
                            loss_type=g3["loss_type"], dpdist=load_dpdist_checkpoint(
                                str(ROOT / aue_golden["dpdist_net"])),
                            run_dir=tmp, device=dev, logger=RunLogger(tmp, echo=False))
        start_count()
        m = tr3.train_step(tmpl3, src3)
        launched = read_count()
        sums = [sum(float(t.sum()) for _, t in tree_flatten_with_paths(b))
                for b in tr3.state["mfv_bn"]]
        with torch.no_grad():
            _, _, poses3 = pcrnet_refine(tr3.params, cfg3, torch.as_tensor(src3, device=dev),
                                         torch.as_tensor(tmpl3, device=dev), iterations=8,
                                         stop_gradient_iters=False, state=tr3.state)
        err_l = abs(float(m["loss"]) - g3["loss"]) / g3["loss"]
        err_g = abs(float(m["grad_norm"]) - g3["grad_norm"]) / g3["grad_norm"]
        err_s = max(abs(a - b) / abs(b) for a, b in zip(sums, g3["state_block_sums"]))
        err_p = float(np.abs(poses3.cpu().numpy() - np.asarray(g3["eval_poses"])).max())
        pcr3_ms = cuda_median_ms(lambda: tr3.train_step(tmpl3, src3), runs=10, warmup=2)
        print(f"pcrnet 3dmfv step (B={g3['batch_size']}, {cfg3.max_loops} loop): loss "
              f"{float(m['loss']):.6f} (JAX {g3['loss']:.6f}, rel |d| {err_l:.2e}), grad norm "
              f"rel |d| {err_g:.2e}, BN state sums rel |d| {err_s:.2e}, eval poses after it max "
              f"|d| {err_p:.2e}; launches { {k: v for k, v in launched.items() if v} }; "
              f"{pcr3_ms:.3f} ms a step (CUDA-event median of 10); on {card}", flush=True)
        check(launched == expected(table_gather_x=2, table_gather_bwd=1),
              "pcrnet 3dmfv: step launches")
        check(err_l <= TOL_PCR_LOSS and err_g <= TOL_PCR3_GNORM and err_s <= TOL_PCR_LOSS
              and err_p <= TOL_PCR3_POSES, "pcrnet 3dmfv: the step is off the golden one")
        del tr3

    with Phase("times"):
        records = []
        B, N, V, E = B_SERVE, NP, G, K ** 3 * C
        # The two-byte dtypes: (record key, dtype, the kernels' C++ type).
        HALVES = (("bf16", torch.bfloat16, "__nv_bfloat16"), ("fp16", torch.float16, "__half"))

        def half_outputs(name, call, kernel, bound_ms, table=None, idx=None):
            """A row's two-byte outputs: per dtype the CUDA-event and device
            ms of call(dtype) (its kernel `kernel<T>`), the bound, and with
            `table` the ms of index_select of `idx` on the table rounded to
            the dtype (else no single library call); printed, and returned
            as the record's entries."""
            out = {}
            for lab, dt, ctype in HALVES:
                ms_ = cuda_median_ms(lambda: call(dt))
                dev_ = device_ms(lambda: call(dt), f"{kernel}<{ctype}")
                lib_ = None
                if table is not None:
                    rounded = table.to(dt)
                    lib_ = cuda_median_ms(lambda: rounded.index_select(0, idx))
                out[lab] = {"ms": ms_, "device_ms": dev_, "bound_ms": bound_ms, "library_ms": lib_}
                print(f"{name} ({lab} output): {ms_:.4f} ms, {dev_:.4f} ms on the device; "
                      f"bound {bound_ms:.4f} ms = {bound_ms / ms_:.1%} / {bound_ms / dev_:.1%} of "
                      f"bound" + ("" if lib_ is None else f"; index_select ({lab}) {lib_:.4f} ms")
                      + f"; on {card}", flush=True)
            return out
        # Rows 2 and 3 are timed on the queries the frozen loss hands them:
        # pcB of the first request, the AB direction, whose surface(A) is
        # the one that needs dfv. The clouds lie inside the grid.
        a, b = requests[0]
        with torch.no_grad():
            x, vox = table_gather_x(fv, b, GRID, K)
        # Neighbour rows of each (query, offset) for the library calls,
        # built outside the timed region.
        rows_idx, inside = neighbour_rows(torch, vox, V)
        fv_pad = torch.cat([fv, torch.zeros(B, 1, C, device=dev)], 1).reshape(-1, C)
        grad_rows = torch.as_tensor(rng.normal(size=(B, N, 3 + E)).astype(np.float32),
                                    device=dev)
        grad_patch = grad_rows[..., 3:]
        src_rows = grad_patch.reshape(-1, C).contiguous()
        sink = torch.zeros(B * (V + 1), C, device=dev)
        # The cells some query's window reaches: the part of fv row 2 must read.
        reached = torch.zeros(B * (V + 1), dtype=torch.bool, device=dev)
        reached[rows_idx] = True
        n_reached = int(reached.view(B, V + 1)[:, :V].sum())
        # The library calls compute the kernels' functions (checked once here).
        check(torch.equal(fv_pad.index_select(0, rows_idx).view(B, N, E), x[..., 3:]),
              "index_select does not reproduce table_gather_x's patches")
        lib_dfv = sink.zero_().index_add_(0, rows_idx, src_rows).view(B, V + 1, C)[:, :V]
        dfv_t = table_gather_bwd(vox, grad_patch, GRID, K)
        err_lib = float((lib_dfv - dfv_t).abs().max())
        check(err_lib <= REL_BWD * float(lib_dfv.abs().max()),
              f"index_add_ does not reproduce table_gather_bwd ({err_lib})")
        check(torch.equal(dfv_t, table_gather_bwd_ordered(vox, grad_patch, GRID, K)),
              "table_gather_bwd differs from the ordered plain sum on the timed inputs")
        del dfv_t
        print(f"timed inputs: {B} clouds x {N} queries, {int((~inside).sum())} of "
              f"{inside.numel()} (query, offset) windows off the grid, {n_reached} of {B * V} "
              f"cells reached", flush=True)

        with torch.no_grad():
            ms = cuda_median_ms(lambda: mfv_x(pts, q, G, SIGMA, GRID, K))
            plain_ms = cuda_median_ms(lambda: mfv_x_plain(pts, q, G, SIGMA, GRID, K))
            # points, queries and two grid tables in; x and vox out; ~40 float32
            # operations per (point, Gaussian) pair in the encode.
            b_ms, b_by = bound(4 * (B_KERNEL * NP * 6 + 2 * G * 3
                                    + B_KERNEL * NP * (3 + E) + B_KERNEL * NP),
                               40 * B_KERNEL * NP * G)
            dev_ms = device_ms(lambda: mfv_x(pts, q, G, SIGMA, GRID, K), "mfv_gather_x_kernel<float")
            # The two-byte outputs: x in half the bytes.
            b_half, _ = bound(4 * (B_KERNEL * NP * 6 + 2 * G * 3 + B_KERNEL * NP)
                              + 2 * B_KERNEL * NP * (3 + E), 40 * B_KERNEL * NP * G)
            halves = half_outputs("mfv_gather_x",
                                  lambda dt: mfv_x(pts, q, G, SIGMA, GRID, K, dtype=dt),
                                  "mfv_gather_x_kernel", b_half)
            # N = 128, the most the route sends to row 1: 2B clouds of 128
            # points and 128 queries (inputs of their own, so that the
            # other phases' draws stay as they were).
            N1 = 2 * NP
            r128 = np.random.default_rng(128)
            p128 = torch.as_tensor(r128.uniform(-0.95, 0.95, (B_KERNEL, N1, 3)).astype(np.float32),
                                   device=dev)
            q128 = torch.as_tensor(r128.uniform(-1.2, 1.2, (B_KERNEL, N1, 3)).astype(np.float32),
                                   device=dev)
            x128, vox128 = mfv_x(p128, q128, G, SIGMA, GRID, K)
            x128_ref, vox128_ref = mfv_x_plain(p128, q128, G, SIGMA, GRID, K)
            err128 = float((x128 - x128_ref).abs().max())
            check(err128 <= TOL_X and torch.equal(vox128, vox128_ref),
                  f"mfv_x at N={N1}: max |dx| {err128} > {TOL_X} or vox differs")
            del x128, x128_ref, vox128, vox128_ref
            ms128 = cuda_median_ms(lambda: mfv_x(p128, q128, G, SIGMA, GRID, K))
            dev128 = device_ms(lambda: mfv_x(p128, q128, G, SIGMA, GRID, K),
                               "mfv_gather_x_kernel<float")
            b128, _ = bound(4 * (B_KERNEL * N1 * 6 + 2 * G * 3 + B_KERNEL * N1 * (3 + E)
                                 + B_KERNEL * N1), 40 * B_KERNEL * N1 * G)
            records.append({"name": "mfv_gather_x", "route": "cuda",
                            "source": "dpdist_tpu_torch/csrc/mfv_gather.cu",
                            "replaces": "dpdist_tpu/kernels/mfv_gather_pallas.py:209",
                            "launches": launches["mfv_gather_x"], "max_abs_err": err_mfv,
                            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                            "library_ms": None, "device_ms": dev_ms, **halves,
                            f"n{N1}": {"ms": ms128, "device_ms": dev128, "bound_ms": b128,
                                       "max_abs_err": err128}})
            print(f"mfv_gather_x at 2B={B_KERNEL}, M=N={N1}: {ms128:.4f} ms, {dev128:.4f} ms on "
                  f"the device; bound {b128:.4f} ms = {b128 / ms128:.1%} / {b128 / dev128:.1%} "
                  f"of bound; max |dx| {err128:.3e} (tol {TOL_X}), vox equal; on {card}",
                  flush=True)
            del p128, q128

            ms = cuda_median_ms(lambda: table_gather_x(fv, b, GRID, K))
            plain_ms = cuda_median_ms(lambda: table_gather_x_plain(fv, b, GRID, K))
            lib_ms = cuda_median_ms(lambda: fv_pad.index_select(0, rows_idx))
            # The reached cells of fv, queries and centres in; x and vox out;
            # no arithmetic but q - centre.
            b_ms, b_by = bound(4 * (n_reached * C + B * N * 3 + V * 3 + B * N * (3 + E) + B * N),
                               3 * B * N)
            dev_ms = device_ms(lambda: table_gather_x(fv, b, GRID, K), "table_gather_x_kernel<float")
            # The two-byte outputs: x in half the bytes; index_select on the
            # volume rounded to the dtype computes the patch part.
            b_half, _ = bound(4 * (n_reached * C + B * N * 3 + V * 3 + B * N)
                              + 2 * B * N * (3 + E), 3 * B * N)
            halves = half_outputs("table_gather_x",
                                  lambda dt: table_gather_x(fv, b, GRID, K, dtype=dt),
                                  "table_gather_x_kernel", b_half, fv_pad, rows_idx)
            records.append({"name": "table_gather_x", "route": "cuda",
                            "source": "dpdist_tpu_torch/csrc/table_gather.cu",
                            "replaces": "dpdist_tpu/kernels/table_gather_pallas.py:539",
                            "launches": launches["table_gather_x"], "max_abs_err": err_tgx,
                            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                            "library_ms": lib_ms, "device_ms": dev_ms, **halves})

            ms = cuda_median_ms(lambda: table_gather_bwd(vox, grad_patch, GRID, K))
            plain_ms = cuda_median_ms(lambda: table_gather_bwd_plain(vox, grad_patch, GRID, K))
            lib_ms = cuda_median_ms(lambda: sink.zero_().index_add_(0, rows_idx, src_rows))
            # The grad entries of in-grid (query, offset) windows and vox in,
            # dfv out; one add per such entry.
            adds = int(inside.sum()) * C
            b_ms, b_by = bound(4 * (adds + B * N + B * V * C), adds)
            dev_ms = device_ms(lambda: table_gather_bwd(vox, grad_patch, GRID, K),
                               "table_gather_bwd_kernel")
            records.append({"name": "table_gather_bwd", "route": "cuda",
                            "source": "dpdist_tpu_torch/csrc/table_gather.cu",
                            "replaces": "dpdist_tpu/kernels/table_gather_pallas.py:237",
                            "launches": launches["table_gather_bwd"], "max_abs_err": err_bwd,
                            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                            "library_ms": lib_ms, "device_ms": dev_ms,
                            # Rows 4 and 5: the same adjoint in two TPU lane layouts.
                            "covers": ["dpdist_tpu/kernels/table_gather_pallas.py:379",
                                       "dpdist_tpu/kernels/table_gather_pallas.py:425"]})

            # Row 3's two-byte kernel on the same queries and the same grad in
            # bf16 and in fp16, strided as a two-byte x's gradient hands it.
            # Its launch plan (the C entry's) is the same for both; its
            # issue-slot floor: the consumer warp-runs that sum (some owner
            # of the warp in the run's window) times the instructions of a
            # run in the SASS of the consumers' loop, over 4 schedulers an
            # SM at the top clock. Out-of-window tests, the producer and the
            # prologue add to it.
            plan_out = (ctypes.c_int64 * 6)()
            build.check_launch(build.library().dpdist_table_gather_bwd_bf16_plan(
                B, GRID, K, C, dev.index, plan_out), "table_gather_bwd_bf16 plan")
            plan16 = dict(zip(("consumers", "parts", "runs", "smem", "blocks", "items"),
                              list(plan_out)))
            n_runs16, warp_runs16 = bwd_bf16_warp_runs(torch, vox, GRID, K, C, plan16)
            print(f"table_gather_bwd_b16_kernel's plan at B={B}: {plan16}; {n_runs16} runs, "
                  f"{warp_runs16} consumer warp-runs that sum", flush=True)
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            # The two-byte grad entries of in-grid windows and vox in, the
            # two-byte dfv out; one float32 add per such entry.
            b16, b16_by = bound(2 * adds + 4 * B * N + 2 * B * V * C, adds)
            for lab, dt, ctype in HALVES:
                grad_patch16 = grad_rows.to(dt)[..., 3:]
                src_rows16 = grad_patch16.reshape(-1, C).contiguous()
                sink16 = torch.zeros(B * (V + 1), C, dtype=dt, device=dev)
                dfv16 = table_gather_bwd(vox, grad_patch16, GRID, K)
                check(torch.equal(dfv16, table_gather_bwd_ordered(vox, grad_patch16, GRID, K)),
                      f"table_gather_bwd {lab} differs from the ordered plain sum on the timed "
                      f"inputs")
                lib16 = sink16.zero_().index_add_(0, rows_idx, src_rows16).view(B, V + 1, C)[:, :V]
                err_lib16 = float((lib16.float() - dfv16.float()).abs().max())
                ms16 = cuda_median_ms(lambda: table_gather_bwd(vox, grad_patch16, GRID, K))
                plain16_ms = cuda_median_ms(lambda: table_gather_bwd_plain(vox, grad_patch16,
                                                                           GRID, K))
                # index_add_ in the dtype (one library call; it sums in the
                # dtype where the kernel sums in float32, up to err_lib16 apart).
                lib16_ms = cuda_median_ms(lambda: sink16.zero_().index_add_(0, rows_idx,
                                                                            src_rows16))
                dev16 = device_ms(lambda: table_gather_bwd(vox, grad_patch16, GRID, K),
                                  f"table_gather_bwd_b16_kernel<{ctype}")
                loop16 = sass_loop_counts(lib_path, f"table_gather_bwd_b16_kernelI{len(ctype)}"
                                          f"{ctype}", "FADD")
                per_run16 = sum(loop16.values()) / (loop16["FADD"] / BWD_BF16_GROUP)
                floor16 = warp_runs16 * per_run16 / (4 * sms) / sm_clock_hz() * 1e3
                records.append({"name": f"table_gather_bwd_{lab}", "route": "cuda",
                                "source": "dpdist_tpu_torch/csrc/table_gather.cu",
                                "replaces": "dpdist_tpu/kernels/table_gather_pallas.py:237",
                                "launches": launches[f"table_gather_bwd_{lab}"],
                                "max_abs_err": err_bwd_half[lab], "ms": ms16,
                                "plain_ms": plain16_ms, "bound_ms": b16, "bound_by": b16_by,
                                "library_ms": lib16_ms, "device_ms": dev16,
                                "library_max_abs_diff": err_lib16, "issue_floor_ms": floor16,
                                "plan": plan16})
                print(f"table_gather_bwd {lab} at B={B}, N={N}: {ms16:.4f} ms, {dev16:.4f} ms on "
                      f"the device; bound {b16:.4f} ms = {b16 / ms16:.1%} / {b16 / dev16:.1%} of "
                      f"bound; its consumers' loop in SASS: {loop16}, {per_run16:.1f} "
                      f"instructions a run, issue-slot floor {floor16:.4f} ms = "
                      f"{floor16 / dev16:.1%} of the device time; index_add_ ({lab}) "
                      f"{lib16_ms:.4f} ms, max |d| {err_lib16:.3e} from the kernel; on {card}",
                      flush=True)
                del sink16, src_rows16, lib16, dfv16, grad_patch16

            # Rows 7 and 6 on the np = 256 path's inputs: pcA of the first
            # large request is encoded, and pcB queries that surface.
            aL, bL = requests_large[0]
            NL = NP_LARGE
            fvL = threedmfv_kernel(aL, G, SIGMA)
            ms = cuda_median_ms(lambda: threedmfv_kernel(aL, G, SIGMA))
            plain_ms = cuda_median_ms(lambda: threedmfv_plain(aL, G, SIGMA))
            # Points and Gaussian centres in, the volumes out.
            b_ms, b_by = bound(4 * (B * NL * 3 + G * 3 + B * G * C),
                               ENCODE_OPS_PER_PAIR * B * NL * G)
            records.append({"name": "threedmfv", "route": "cuda",
                            "source": "dpdist_tpu_torch/csrc/threedmfv.cu",
                            "replaces": "dpdist_tpu/kernels/threedmfv_pallas.py:192",
                            "launches": launches["threedmfv"], "max_abs_err": err_enc,
                            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                            "library_ms": None})
            # The crossover against the plain encode, and eval_pair's one
            # large cloud (one block on one SM).
            for cloud in (a, aL, eA):
                k_ms = cuda_median_ms(lambda: threedmfv_kernel(cloud, G, SIGMA))
                p_ms = cuda_median_ms(lambda: threedmfv_plain(cloud, G, SIGMA))
                print(f"encode at B={cloud.shape[0]}, N={cloud.shape[1]}: kernel {k_ms:.4f} ms, "
                      f"plain {p_ms:.4f} ms (kernel / plain = {k_ms / p_ms:.3f}); on {card}",
                      flush=True)

            voxL = voxel_assign(bL, GRID)[0]
            rows6, inside6 = neighbour_rows(torch, voxL, V)
            fv_pad6 = torch.cat([fvL, torch.zeros(B, 1, C, device=dev)], 1).reshape(-1, C)
            reached6 = torch.zeros(B * (V + 1), dtype=torch.bool, device=dev)
            reached6[rows6] = True
            n_reached6 = int(reached6.view(B, V + 1)[:, :V].sum())
            check(torch.equal(fv_pad6.index_select(0, rows6).view(B, NL, E),
                              table_gather(fvL, voxL, GRID, K)),
                  "index_select does not reproduce table_gather")
            print(f"row 6 timed inputs: {B} clouds x {NL} queries, {int((~inside6).sum())} of "
                  f"{inside6.numel()} windows off the grid, {n_reached6} of {B * V} cells "
                  f"reached", flush=True)
            ms = cuda_median_ms(lambda: table_gather(fvL, voxL, GRID, K))
            plain_ms = cuda_median_ms(lambda: table_gather_plain(fvL, voxL, GRID, K))
            lib_ms = cuda_median_ms(lambda: fv_pad6.index_select(0, rows6))
            # The reached cells of fv and vox in, the patch rows out; no arithmetic.
            b_ms, b_by = bound(4 * (n_reached6 * C + B * NL + B * NL * E), 0)
            dev_ms = device_ms(lambda: table_gather(fvL, voxL, GRID, K),
                               "table_gather_rows_kernel<float")
            # The two-byte outputs: the rows in half the bytes; index_select
            # on the volume rounded to the dtype computes the same rows.
            b_half, _ = bound(4 * (n_reached6 * C + B * NL) + 2 * B * NL * E, 0)
            halves = half_outputs("table_gather",
                                  lambda dt: table_gather(fvL, voxL, GRID, K, dtype=dt),
                                  "table_gather_rows_kernel", b_half, fv_pad6, rows6)
            records.append({"name": "table_gather", "route": "cuda",
                            "source": "dpdist_tpu_torch/csrc/table_gather.cu",
                            "replaces": "dpdist_tpu/kernels/table_gather_pallas.py:106",
                            "launches": launches["table_gather"], "max_abs_err": err_tg6,
                            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                            "library_ms": lib_ms, "device_ms": dev_ms, **halves})

            # Row 3 at N = 256 on the np = 256 frozen loss's inputs: pcB's
            # voxels, and a contiguous grad as row 6's backward hands it.
            gradL = torch.as_tensor(rng.normal(size=(B, NL, E)).astype(np.float32), device=dev)
            srcL = gradL.reshape(-1, C)
            sinkL = torch.zeros(B * (V + 1), C, device=dev)
            # Against float64 sums: two float32 orders of up to 4x as many
            # terms a slot as at N = 64 differ by up to ~8e-7 of the largest
            # entry; each alone strays from the exact sum by less.
            dfvL = table_gather_bwd(voxL, gradL, GRID, K)
            refL = table_gather_bwd_plain(voxL, gradL.double(), GRID, K)
            libL = sinkL.zero_().index_add_(0, rows6, srcL).view(B, V + 1, C)[:, :V]
            tolL = REL_BWD * float(refL.abs().max())
            errL = float((dfvL.double() - refL).abs().max())
            check(errL <= tolL, f"table_gather_bwd at N={NL}: max |d dfv| {errL} > {tolL}")
            check(float((libL.double() - refL).abs().max()) <= tolL,
                  f"index_add_ does not compute table_gather_bwd's function at N={NL}")
            check(torch.equal(dfvL, table_gather_bwd_ordered(voxL, gradL, GRID, K)),
                  f"table_gather_bwd at N={NL} differs from the ordered plain sum")
            del refL, libL
            msL = cuda_median_ms(lambda: table_gather_bwd(voxL, gradL, GRID, K))
            devL = device_ms(lambda: table_gather_bwd(voxL, gradL, GRID, K),
                             "table_gather_bwd_kernel")
            libL_ms = cuda_median_ms(lambda: sinkL.zero_().index_add_(0, rows6, srcL))
            addsL = int(inside6.sum()) * C
            bnd_L, _ = bound(4 * (addsL + B * NL + B * V * C), addsL)
            next(r for r in records if r["name"] == "table_gather_bwd")[f"n{NL}"] = {
                "ms": msL, "device_ms": devL, "bound_ms": bnd_L, "library_ms": libL_ms,
                "max_abs_err": errL}
            print(f"table_gather_bwd at B={B}, N={NL} (contiguous grad): {msL:.4f} ms, "
                  f"{devL:.4f} ms on the device; bound {bnd_L:.4f} ms = {bnd_L / msL:.1%} / "
                  f"{bnd_L / devL:.1%} of bound; index_add_ {libL_ms:.4f} ms; max |d dfv| "
                  f"{errL:.3e} from float64 sums (tol {tolL:.3e}), equal to the ordered plain "
                  f"sum; on {card}",
                  flush=True)
            del fv_pad6, reached6, rows6, srcL, sinkL, dfvL

            # Row 3's two-byte kernel at N = 256 (row 6's contiguous grad).
            bnd_L16, _ = bound(2 * addsL + 4 * B * NL + 2 * B * V * C, addsL)
            for lab, dt, ctype in HALVES:
                gradL16 = gradL.to(dt)
                check(torch.equal(table_gather_bwd(voxL, gradL16, GRID, K),
                                  table_gather_bwd_ordered(voxL, gradL16, GRID, K)),
                      f"table_gather_bwd {lab} at N={NL} differs from the ordered plain sum")
                msL16 = cuda_median_ms(lambda: table_gather_bwd(voxL, gradL16, GRID, K))
                devL16 = device_ms(lambda: table_gather_bwd(voxL, gradL16, GRID, K),
                                   f"table_gather_bwd_b16_kernel<{ctype}")
                next(r for r in records if r["name"] == f"table_gather_bwd_{lab}")[f"n{NL}"] = {
                    "ms": msL16, "device_ms": devL16, "bound_ms": bnd_L16}
                print(f"table_gather_bwd {lab} at B={B}, N={NL}: {msL16:.4f} ms, {devL16:.4f} ms "
                      f"on the device; bound {bnd_L16:.4f} ms = {bnd_L16 / msL16:.1%} / "
                      f"{bnd_L16 / devL16:.1%} of bound; on {card}", flush=True)
            del gradL16, gradL

            # Row 8 on eval_pair's clouds, one direction.
            NE = eA.shape[1]
            lib_nn = torch.cdist(eA, eB, compute_mode="donot_use_mm_for_euclid_dist").square()
            lib_nn = lib_nn.amin(-1)
            d_nn = nn_min_sqdist(eA, eB)
            check(bool(((lib_nn - d_nn).abs() <= TOL_NN_ABS + TOL_NN_REL * d_nn.abs()).all()),
                  "torch.cdist does not reproduce nn_min_sqdist")
            ms = cuda_median_ms(lambda: nn_min_sqdist(eA, eB))
            plain_ms = cuda_median_ms(lambda: nn_min_sqdist_plain(eA, eB))
            lib_ms = cuda_median_ms(lambda: torch.cdist(
                eA, eB, compute_mode="donot_use_mm_for_euclid_dist").square().amin(-1))
            # Both clouds in, the minima out.
            b_ms, b_by = bound(4 * (NE * 3 + eB.shape[1] * 3 + NE),
                               NN_OPS_PER_PAIR * NE * eB.shape[1])
            dev_ms = device_ms(lambda: nn_min_sqdist(eA, eB), "nn_min_kernel")
            # The issue slots the per-dimension form needs, at the card's
            # top SM clock (a lower clock under load would lower the floor).
            sm_hz = sm_clock_hz()
            sms = torch.cuda.get_device_properties(dev).multi_processor_count

            def issue_floor_ms(pairs):
                return pairs * NN_INSTRUCTIONS_PER_PAIR / 32 / (4 * sms) / sm_hz * 1e3

            floor_ms = issue_floor_ms(NE * eB.shape[1])
            loop = sass_loop_counts(lib_path, "nn_min_kernel")
            print(f"nn_min_kernel's inner loop in SASS: {loop}; "
                  f"{sum(loop.values()) / loop['FMNMX']:.2f} instructions a pair", flush=True)
            records.append({"name": "nn_min_sqdist", "route": "cuda",
                            "source": "dpdist_tpu_torch/csrc/chamfer.cu",
                            "replaces": "dpdist_tpu/kernels/chamfer_pallas.py:74",
                            "launches": launches["nn_min_sqdist"], "max_abs_err": err_nn,
                            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                            "library_ms": lib_ms, "device_ms": dev_ms,
                            "issue_floor_ms": floor_ms})
            print(f"nn_min_sqdist at B=1, N=M={NE}: {dev_ms:.4f} ms on the device, one launch "
                  f"({nn_plan(1, NE, eB.shape[1])}); the issue-slot floor of the per-dimension "
                  f"form ({NN_INSTRUCTIONS_PER_PAIR} instructions a pair, {sms} SMs at "
                  f"{sm_hz / 1e6:.0f} MHz) {floor_ms:.4f} ms = {floor_ms / dev_ms:.1%} of it; "
                  f"the two-kernel design before it read 0.0452 / 0.0448 ms (PERF.md); "
                  f"cdist {lib_ms:.4f} ms; on {card}", flush=True)
            del lib_nn, d_nn
            # Row 8 as the ground-truth generator runs it: 50,000 candidates
            # against a 10,000-point surface.
            ga, gp = (torch.as_tensor(x_[None], device=dev) for x_ in (gt_cand, gt_surface))
            ms_gt = cuda_median_ms(lambda: nn_min_sqdist(ga, gp))
            dev_gt = device_ms(lambda: nn_min_sqdist(ga, gp), "nn_min_kernel")
            b_gt, _ = bound(4 * (GT_CANDIDATES * 3 + GT_SURFACE * 3 + GT_CANDIDATES),
                            NN_OPS_PER_PAIR * GT_CANDIDATES * GT_SURFACE)
            next(r for r in records if r["name"] == "nn_min_sqdist")["gtgen_N50000_M10000"] = {
                "ms": ms_gt, "device_ms": dev_gt, "bound_ms": b_gt,
                "issue_floor_ms": issue_floor_ms(GT_CANDIDATES * GT_SURFACE),
                "native_host_ms": native_s * 1e3}
            print(f"nn_min_sqdist at N={GT_CANDIDATES}, M={GT_SURFACE} (gtgen): {ms_gt:.4f} ms, "
                  f"{dev_gt:.4f} ms on the device ({nn_plan(1, GT_CANDIDATES, GT_SURFACE)}); bound "
                  f"{b_gt:.4f} ms; issue-slot floor {issue_floor_ms(GT_CANDIDATES * GT_SURFACE):.4f}"
                  f" ms; the native host library {native_s * 1e3:.1f} ms; on {card}", flush=True)
            del ga, gp
            # The NN-min at the other shapes of its checks: eval and device times.
            for B_, N_, M_ in ((2, 1000, 4099), (256, 64, 64)):
                a_, p_ = (torch.as_tensor(np.random.default_rng(N_).uniform(
                    -1.0, 1.0, (B_, n, 3)).astype(np.float32), device=dev) for n in (N_, M_))
                ms_ = cuda_median_ms(lambda: nn_min_sqdist(a_, p_))
                dev_ = device_ms(lambda: nn_min_sqdist(a_, p_), "nn_min_kernel")
                next(r for r in records if r["name"] == "nn_min_sqdist")[f"B{B_}_N{N_}_M{M_}"] = {
                    "ms": ms_, "device_ms": dev_, "issue_floor_ms": issue_floor_ms(B_ * N_ * M_)}
                print(f"nn_min_sqdist at B={B_}, N={N_}, M={M_}: {ms_:.4f} ms, {dev_:.4f} ms on "
                      f"the device ({nn_plan(B_, N_, M_)}); issue-slot floor "
                      f"{issue_floor_ms(B_ * N_ * M_):.4f} ms; on {card}", flush=True)
            del a_, p_

            # Row 9 on the first np = 64 request as the "full" route builds
            # it (2B = 512 clouds, all queries inside the grid).
            fv2, vox2, _, delta2 = ff_inputs(a, b, off_grid=False)
            rows9 = vox2.numel()
            layers_bf = [{k_: t.to(torch.bfloat16) for k_, t in lp.items()}
                         for lp in params0["decoder"]["layers"]]
            rows_idx9, _ = neighbour_rows(torch, vox2, V)
            fv_pad9 = torch.cat([fv2, torch.zeros(2 * B, 1, C, dtype=torch.bfloat16, device=dev)],
                                1).reshape(-1, C)

            def composed_bf16():
                """The composed bf16 path over the same rows: index_select
                gathers the patches, cuBLAS runs the decoder (a composition
                of library calls, not one call)."""
                x9 = torch.cat([delta2.to(torch.bfloat16),
                                fv_pad9.index_select(0, rows_idx9).view(2 * B, N, E)], -1)
                return mlp_apply({"layers": layers_bf}, x9, torch.bfloat16)

            y_lib = composed_bf16().float()
            y9 = fused_forward(fv2, vox2, delta2, packed0, GRID, K)
            print(f"row 9 timed inputs: {2 * B} clouds x {N} queries; the composed bf16 "
                  f"path's output vs the kernel's: max |dy| = "
                  f"{float((y_lib - y9).abs().max()):.3e} (it rounds each product to bf16 "
                  f"before the bias and the head's output)", flush=True)
            ms = cuda_median_ms(lambda: fused_forward(fv2, vox2, delta2, packed0, GRID, K))
            plain_ms = cuda_median_ms(lambda: fused_forward_plain(fv2, vox2, delta2, packed0,
                                                                  GRID, K))
            lib_ms = cuda_median_ms(composed_bf16)
            x9 = torch.cat([delta2.to(torch.bfloat16),
                            fv_pad9.index_select(0, rows_idx9).view(2 * B, N, E)], -1)
            dec_ms = cuda_median_ms(lambda: mlp_apply({"layers": layers_bf}, x9, torch.bfloat16))
            widths9 = [lp["w"].shape for lp in params0["decoder"]["layers"]]
            flops9 = 2 * rows9 * sum(i * o for i, o in widths9)
            # fv, vox and delta in, y out, the weights and biases once.
            bytes9 = (fv2.numel() * 2 + rows9 * (4 + 12 + 4 * 3)
                      + sum(i * o * 2 + o * 4 for i, o in widths9))
            b_ms, b_by = bound(bytes9, flops9, BF16_FLOP_PER_S)
            records.append({"name": "fused_forward", "route": "cuda",
                            "source": "dpdist_tpu_torch/csrc/fused_forward.cu",
                            "replaces": "dpdist_tpu/kernels/fused_forward_pallas.py:121",
                            "launches": launches["fused_forward"], "max_abs_err": err_ff,
                            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                            "library_ms": lib_ms, "library_is": "composition: index_select "
                            "gather + torch.matmul bf16 decoder (cuBLAS)"})
            print(f"row 9: {flops9 / 1e12:.4f} TFLOP over {rows9} rows, bound at the "
                  f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s dense bf16 peak (H100 SXM data "
                  f"sheet); the composed path's decoder "
                  f"alone (cuBLAS bf16) {dec_ms:.4f} ms = {flops9 / dec_ms / 1e9:.1f} TFLOP/s, "
                  f"the kernel {flops9 / ms / 1e9:.1f} TFLOP/s; on {card}", flush=True)
            # The same cuBLAS bf16 decoder with the first layer's K padded
            # with zeros to the pack's K (a yardstick only: the port never
            # runs it).
            k_pad = packed0.w[0].shape[1]
            x9_pad = torch.cat([x9, torch.zeros(*x9.shape[:-1], k_pad - x9.shape[-1],
                                                dtype=torch.bfloat16, device=dev)], -1)
            layers_pad = [{"w": torch.cat([layers_bf[0]["w"], torch.zeros(
                k_pad - layers_bf[0]["w"].shape[0], layers_bf[0]["w"].shape[1],
                dtype=torch.bfloat16, device=dev)]), "b": layers_bf[0]["b"]}] + layers_bf[1:]
            dec_pad_ms = cuda_median_ms(lambda: mlp_apply({"layers": layers_pad}, x9_pad,
                                                          torch.bfloat16))
            print(f"cuBLAS bf16 decoder with the first layer's K padded from {x9.shape[-1]} to "
                  f"{k_pad}: {dec_pad_ms:.4f} ms = {flops9 / dec_pad_ms / 1e9:.1f} TFLOP/s "
                  f"(unpadded {dec_ms:.4f} ms); on {card}", flush=True)
            # The same composed decoder in fp16 (the fp16 "auto" path's,
            # cuBLAS fp16 accumulating in float32), unpadded and padded.
            h = torch.float16
            layers_h = [{k_: t.to(h) for k_, t in lp.items()} for lp in layers_bf]
            layers_pad_h = [{k_: t.to(h) for k_, t in lp.items()} for lp in layers_pad]
            x9_h, x9_pad_h = x9.to(h), x9_pad.to(h)
            dec_h_ms = cuda_median_ms(lambda: mlp_apply({"layers": layers_h}, x9_h, h))
            dec_pad_h_ms = cuda_median_ms(lambda: mlp_apply({"layers": layers_pad_h}, x9_pad_h, h))
            print(f"cuBLAS fp16 decoder on the same rows: {dec_h_ms:.4f} ms = "
                  f"{flops9 / dec_h_ms / 1e9:.1f} TFLOP/s; K padded to {k_pad}: "
                  f"{dec_pad_h_ms:.4f} ms = {flops9 / dec_pad_h_ms / 1e9:.1f} TFLOP/s; on {card}",
                  flush=True)
            del layers_h, layers_pad_h, x9_h, x9_pad_h
            # Row 9 at np = 256: the "full" route's 2B = 512 clouds of 256 queries.
            fv2L, vox2L, _, delta2L = ff_inputs(aL, bL, off_grid=False)
            rows9L = vox2L.numel()
            ms9L = cuda_median_ms(lambda: fused_forward(fv2L, vox2L, delta2L, packed0, GRID, K))
            flops9L = 2 * rows9L * sum(i * o for i, o in widths9)
            b9L, _ = bound(fv2L.numel() * 2 + rows9L * (4 + 12 + 4 * 3)
                           + sum(i * o * 2 + o * 4 for i, o in widths9), flops9L, BF16_FLOP_PER_S)
            print(f"row 9 at np={NL}: {ms9L:.4f} ms over {rows9L} rows = "
                  f"{flops9L / ms9L / 1e9:.1f} TFLOP/s, {b9L / ms9L:.1%} of its {b9L:.4f} ms "
                  f"bound; at np={N}: {ms:.4f} ms = {flops9 / ms / 1e9:.1f} TFLOP/s; on {card}",
                  flush=True)
            # Device time per CUDA kernel of rows 9 and 7 (a call of either
            # launches more than one): torch.profiler over 5 calls each.
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    fused_forward(fv2, vox2, delta2, packed0, GRID, K)
                for cloud in (aL, eA):
                    for _ in range(5):
                        threedmfv_kernel(cloud, G, SIGMA)
                torch.cuda.synchronize()
            for e in prof.key_averages():
                if any(k_ in e.key for k_ in ("layer_kernel", "head_kernel", "partial_kernel",
                                              "merge_kernel")):
                    print(f"profiled kernel {e.key[:60]}: {e.count} launches, "
                          f"{e.self_device_time_total / e.count:.1f} us each (rows 9 at np={N}, 7 at B={B}, N={NL} "
                          f"and B=1, N={eA.shape[1]}); on {card}", flush=True)
            del x9, y_lib, y9, fv_pad9, rows_idx9, x9_pad, layers_pad, fv2L, vox2L, delta2L

            # Row 10 on the first np = 64 request: pcA's volumes, pcB's queries.
            fv10 = threedmfv(a, G, SIGMA).detach()
            vox10, mask10, _ = voxel_assign(b, GRID)
            nid = neighbor_ids(vox10, mask10, GRID, K).long()
            base10 = (torch.arange(B, device=dev) * (V + 1))[:, None, None]
            rows10 = (base10 + torch.where(nid >= 0, nid, torch.full_like(nid, V))).reshape(-1)
            fv_pad10 = torch.cat([fv10, torch.zeros(B, 1, C, device=dev)], 1).reshape(-1, C)
            check(torch.equal(fv_pad10.index_select(0, rows10).view(B, N, E),
                              gather_patches_fused(fv10, vox10, mask10, GRID, K)),
                  "index_select does not reproduce gather_patches_fused")
            reached10 = torch.zeros(B * (V + 1), dtype=torch.bool, device=dev)
            reached10[rows10] = True
            n_reached10 = int(reached10.view(B, V + 1)[:, :V].sum())
            ms = cuda_median_ms(lambda: gather_patches_fused(fv10, vox10, mask10, GRID, K))
            plain_ms = cuda_median_ms(lambda: gather_patches_fused_plain(fv10, vox10, mask10,
                                                                         GRID, K))
            lib_ms = cuda_median_ms(lambda: fv_pad10.index_select(0, rows10))
            # The reached cells of fv, vox and mask in, the patch rows out; no
            # arithmetic.
            b_ms, b_by = bound(4 * (n_reached10 * C + 2 * B * N + B * N * E), 0)
            dev_ms = device_ms(lambda: gather_patches_fused(fv10, vox10, mask10, GRID, K),
                               "gather_fused_kernel")
            records.append({"name": "gather_patches_fused", "route": "cuda",
                            "source": "dpdist_tpu_torch/csrc/gather_fused.cu",
                            "replaces": "dpdist_tpu/kernels/gather_pallas.py:137",
                            "launches": launches["gather_patches_fused"], "max_abs_err": err_g10,
                            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                            "library_ms": lib_ms, "device_ms": dev_ms})
            del fv_pad10, rows10, reached10, nid

            # Adam over the production AUE's 24 leaves (407.8 M weights) at
            # step 3: the kernel against the list path on the same inputs,
            # p, mu and nu bit for bit, in one launch.
            gen_a = torch.Generator(device=dev).manual_seed(25)
            n_w = sum(int(np.prod(s_)) for s_ in aue_shapes)
            ps_a = [torch.randn(s_, generator=gen_a, device=dev) for s_ in aue_shapes]
            gs_a = [torch.randn(s_, generator=gen_a, device=dev)
                    * torch.exp(4 * torch.randn(s_, generator=gen_a, device=dev))
                    for s_ in aue_shapes]
            ms_a = [0.1 * torch.randn(s_, generator=gen_a, device=dev) for s_ in aue_shapes]
            vs_a = [torch.rand(s_, generator=gen_a, device=dev) for s_ in aue_shapes]
            lr_a, c1_a, c2_a = 1e-3, *(float(np.float32(1) - np.float32(b_) ** np.float32(3))
                                       for b_ in (B1, B2))
            ps_r = [t.clone() for t in ps_a]
            want_a = [adam_leaf_plain(*q, lr_a, c1_a, c2_a) for q in zip(ps_r, gs_a, ms_a, vs_a)]
            fused_adam.launches = 0
            fused_adam(ps_a, gs_a, ms_a, vs_a, lr_a, c1_a, c2_a, B1, B2, EPS)
            torch.cuda.synchronize()
            adam_launched = fused_adam.launches
            err_adam = max(float((x_ - y_).abs().max()) for x_, y_ in zip(
                [*ps_a, *ms_a, *vs_a], [*ps_r, *(w_[0] for w_ in want_a), *(w_[1] for w_ in want_a)]))
            same_adam = all(torch.equal(x_, y_) for x_, y_ in zip(
                [*ps_a, *ms_a, *vs_a], [*ps_r, *(w_[0] for w_ in want_a), *(w_[1] for w_ in want_a)]))
            print(f"fused_adam on the AUE's {len(aue_shapes)} leaves ({n_w} weights): "
                  f"{adam_launched} launch; p, mu and nu against the list path: max |d| "
                  f"{err_adam:.3e}, equal {same_adam} (tol 0)", flush=True)
            check(same_adam and adam_launched == 1,
                  f"fused_adam: not the list path bit for bit (max |d| {err_adam}) or "
                  f"{adam_launched} launches")
            del want_a
            adam_call = lambda: fused_adam(ps_a, gs_a, ms_a, vs_a, lr_a, c1_a, c2_a, B1, B2, EPS)
            ms = cuda_median_ms(adam_call)
            plain_ms = cuda_median_ms(lambda: [adam_leaf_plain(*q, lr_a, c1_a, c2_a) for q
                                               in zip(ps_r, gs_a, ms_a, vs_a)])
            # p, g, m and v in, p, m and v out; 14 operations a weight.
            b_ms, b_by = bound(28 * n_w, 14 * n_w)
            dev_ms = device_ms(adam_call, "fused_adam_kernel")
            records.append({"name": "fused_adam", "route": "cuda",
                            "source": "dpdist_tpu_torch/csrc/fused_adam.cu",
                            "replaces": "optax.adam (dpdist_tpu/train/optim.py:25)",
                            "launches": launches["fused_adam"], "max_abs_err": err_adam,
                            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                            "library_ms": None, "device_ms": dev_ms})
            del ps_a, gs_a, ms_a, vs_a, ps_r
            torch.cuda.empty_cache()

            for r in records:
                on_device = (f", {r['device_ms']:.4f} ms on the device = "
                             f"{r['bound_ms'] / r['device_ms']:.1%} of bound"
                             if "device_ms" in r else "")
                print(f"{r['name']} kernel: {r['ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
                      f"({r['bound_by']}) = {r['bound_ms'] / r['ms']:.1%} of bound{on_device}; "
                      f"plain {r['plain_ms']:.4f} ms; library call {r['library_ms']} ms; "
                      f"main-path launches {r['launches']}; on {card}", flush=True)

            fwd_ms = cuda_median_ms(lambda: fwd_model(a, b))
        print(f"forward (mfv kernel path) at B={B_SERVE} pairs: {fwd_ms:.4f} ms, "
              f"{B_SERVE / fwd_ms * 1e3:.1f} pairs/s; on {card}", flush=True)
        cfg, np_params, _ = load_dpdist_checkpoint(str(ROOT / NETS[-1]))
        params = params_from_jax(np_params, dev)
        for mode in ("table", "mfv"):
            loss_fn = make_frozen_dpdist_loss(params, cfg.replace(fused_gather=mode))
            step_ms = cuda_median_ms(lambda: src_grad(loss_fn, a, b))
            print(f"frozen source-gradient step ({mode} path) at B={B_SERVE} pairs: "
                  f"{step_ms:.4f} ms, {B_SERVE / step_ms * 1e3:.1f} pairs/s; on {card}",
                  flush=True)
        labels_t = torch.as_tensor(rng.uniform(0.0, 0.3, (B_SERVE, NP)).astype(np.float32),
                                   device=dev)

        def train_step():
            loss, grads = trainer.loss_and_grads(a, b, labels_t)
            trainer.opt_state = trainer.optimizer.step(trainer.params, grads, trainer.opt_state)

        step_ms = cuda_median_ms(train_step)
        print(f"train step (table path, Adam) at B={B_SERVE} pairs: {step_ms:.4f} ms, "
              f"{B_SERVE / step_ms * 1e3:.1f} pairs/s; on {card}", flush=True)

        # The bf16 train step (f32 master weights, bf16 decoder), at B = 16
        # (the train phases' batch) and at B = 256.
        with tempfile.TemporaryDirectory() as tmp16:
            t16 = DPDistTrainer(DPDistConfig(dtype="bfloat16"), tcfg, run_dir=tmp16, device=dev,
                                logger=RunLogger(tmp16, echo=False))
            for batch_ in (t16.make_batch(data, labels)[:3], (a, b, labels_t)):
                def step16():
                    _, grads16 = t16.loss_and_grads(*batch_)
                    t16.opt_state = t16.optimizer.step(t16.params, grads16, t16.opt_state)

                ms_ = cuda_median_ms(step16)
                n_ = batch_[0].shape[0]
                print(f"train step bf16 (table path, Adam) at B={n_} pairs: {ms_:.4f} ms, "
                      f"{n_ / ms_ * 1e3:.1f} pairs/s; on {card}", flush=True)
            del t16
            # The fp16 train step at B = 256.
            t_h = DPDistTrainer(DPDistConfig(dtype="float16"), tcfg, run_dir=tmp16, device=dev,
                                logger=RunLogger(tmp16, echo=False))

            def step_h():
                _, grads_h = t_h.loss_and_grads(a, b, labels_t)
                t_h.opt_state = t_h.optimizer.step(t_h.params, grads_h, t_h.opt_state)

            ms_ = cuda_median_ms(step_h)
            print(f"train step fp16 (table path, Adam) at B={B_SERVE} pairs: {ms_:.4f} ms, "
                  f"{B_SERVE / ms_ * 1e3:.1f} pairs/s; on {card}", flush=True)
            del t_h

        with torch.no_grad():
            fwd_ms = cuda_median_ms(lambda: fwd_model_large(aL, bL))
        print(f"forward (encode + patch-only gather path) at B={B_SERVE} pairs, np={NL}: "
              f"{fwd_ms:.4f} ms, {B_SERVE / fwd_ms * 1e3:.1f} pairs/s; on {card}", flush=True)
        for reqs in (requests, requests_large):
            a_, b_ = reqs[0]
            for lab_, dt_ in (("bf16", "bfloat16"), ("fp16", "float16")):
                loss16 = make_frozen_dpdist_loss(params, cfg.replace(dtype=dt_))
                step_ms = cuda_median_ms(lambda: src_grad(loss16, a_, b_))
                print(f"frozen source-gradient step {lab_} (table path, row 3 {lab_}) at "
                      f"B={B_SERVE} pairs, np={a_.shape[1]}: {step_ms:.4f} ms, "
                      f"{B_SERVE / step_ms * 1e3:.1f} pairs/s; on {card}", flush=True)
        loss_fn = make_frozen_dpdist_loss(params, cfg)
        step_ms = cuda_median_ms(lambda: src_grad(loss_fn, aL, bL))
        print(f"frozen source-gradient step at B={B_SERVE} pairs, np={NL}: {step_ms:.4f} ms, "
              f"{B_SERVE / step_ms * 1e3:.1f} pairs/s; on {card}", flush=True)

        for reqs in (requests, requests_large):
            a_, b_ = reqs[0]
            for over in ({"dtype": "bfloat16", "fused_gather": "full"},
                         {"dtype": "bfloat16", "fused_gather": "auto"},
                         {"dtype": "float16", "fused_gather": "auto"},
                         {"fused_gather": "on"}):
                model = load_frozen_distance(str(ROOT / NETS[-1]), device=dev, **over)
                with torch.no_grad():
                    fwd_ms = cuda_median_ms(lambda: model(a_, b_))
                print(f"forward ({over}) at B={B_SERVE} pairs, np={a_.shape[1]}: "
                      f"{fwd_ms:.4f} ms, {B_SERVE / fwd_ms * 1e3:.1f} pairs/s; on {card}",
                      flush=True)

        eval_model = load_frozen_distance(str(ROOT / NETS[0]), device=dev)
        with torch.no_grad():
            key_ms = {"dpdist": cuda_median_ms(lambda: eval_model(eA, eB), runs=5),
                      "chamfer": cuda_median_ms(lambda: chamfer_distance(eA, eB), runs=5),
                      "emd": cuda_median_ms(lambda: earth_mover_distance(eA, eB), runs=3,
                                            warmup=1)}
        print(f"eval_pair at {EVAL_POINTS} points: end to end {eval_e2e_ms:.1f} ms (host "
              f"clock, median of 3, checkpoint load and file parse included); per key "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in key_ms.items()) + f"; on {card}",
              flush=True)

        # Rows 2 and 3's share of a PCRNet train step's device time (the
        # production recipe, resumed), over the kernel records torch.profiler
        # keeps of PROFILED_STEPS steps. Last, so that no short profiled run
        # above follows this long trace (after it sat in train_pcrnet, the
        # profiler kept no record of row 10 in six sessions). Sessions repeat
        # until both rows show.
        from torch.profiler import ProfilerActivity, profile

        for session in range(1, 5):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(PROFILED_STEPS):
                    resumed.train_step(tmpl, src, pose6)
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
            share = {row: [e for e in events if name in e.key]
                     for row, name in (("row 2", "table_gather_x_kernel"),
                                       ("row 3", "table_gather_bwd_kernel"))}
            if all(share.values()):
                break
        check(all(share.values()), "train_pcrnet: the profile shows no launch of row 2 or 3")
        total_us = sum(e.self_device_time_total for e in events)
        kept = sum(e.count for e in events)
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
        print(f"train_pcrnet step under torch.profiler, {PROFILED_STEPS} steps (session "
              f"{session}, {kept} device records kept): device time {total_us / PROFILED_STEPS:.1f}"
              f" us a step, " + ", ".join(
                  f"{row} {sum(e.self_device_time_total for e in v):.1f} us in "
                  f"{sum(e.count for e in v)} launches "
                  f"({sum(e.self_device_time_total for e in v) / total_us:.2%})"
                  for row, v in share.items())
              + "; top: " + "; ".join(f"{e.key[:40]} {e.self_device_time_total:.1f} us"
                                      for e in top) + f"; on {card}", flush=True)
        del resumed

        # The same for the production AUE step ("ours", B = 16): device time
        # a step, rows 2 and 3's share of it, and the idle share of the
        # CUDA-event step time (aue_ms, taken in the aue phase).
        for session in range(1, 5):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(PROFILED_STEPS):
                    aue_prof.train_step(aue_data)
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
            share = {row: [e for e in events if name in e.key]
                     for row, name in (("row 2", "table_gather_x_kernel"),
                                       ("row 3", "table_gather_bwd_kernel"))}
            if all(share.values()):
                break
        check(all(share.values()), "aue: the profile shows no launch of row 2 or 3")
        total_us = sum(e.self_device_time_total for e in events)
        # One row-3 launch a step: the steps whose records the profiler kept.
        kept_steps = sum(e.count for e in share["row 3"])
        step_dev_ms = total_us / max(kept_steps, 1) / 1e3
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
        print(f"aue 3dmfv ours step under torch.profiler, {PROFILED_STEPS} steps (session "
              f"{session}, {kept_steps} steps' row-3 records kept): device time "
              f"{step_dev_ms:.3f} ms a step of {aue_ms:.3f} ms (idle share "
              f"{1 - step_dev_ms / aue_ms:.1%}), " + ", ".join(
                  f"{row} {sum(e.self_device_time_total for e in v):.1f} us in "
                  f"{sum(e.count for e in v)} launches "
                  f"({sum(e.self_device_time_total for e in v) / total_us:.2%})"
                  for row, v in share.items())
              + "; top: " + "; ".join(f"{e.key[:40]} {e.self_device_time_total:.1f} us"
                                      for e in top) + f"; on {card}", flush=True)
        del aue_prof

    # ------------------------------------------------------------------
    # The DPDist model family at full width (seeded weights) and dense
    # evaluation, against golden_variants.json (JAX on the CPU). They run
    # after `times`, so that its profiles follow the same phases as before
    # them (in one call with them before it, torch.profiler kept no record
    # of row 2 in six sessions; in the next, without them, none of row 1's
    # bf16 output; device_ms now lengthens a session after an empty one).
    # Their launches join the kernels' records below.
    vgold = json.loads(VARIANTS_GOLDEN_PATH.read_text())

    with Phase("c7_kernels"):
        # Rows 2, 3, 6, 10 and 9 at C = 7 (the 7-channel encode's volumes) on
        # the main path's shapes, each against its plain version.
        C7 = 7
        a7, q7 = make_kernel_inputs(rng, torch, dev, B_SERVE)
        fv7 = threedmfv_plain(a7, G, SIGMA, full_fv=False).contiguous()
        check(fv7.shape == (B_SERVE, G, C7), f"7-channel encode shape {tuple(fv7.shape)}")
        with torch.no_grad():
            x7, vox7 = table_gather_x(fv7, q7, GRID, K)
            x7_ref, vox7_ref = table_gather_x_plain(fv7, q7, GRID, K)
        check(torch.equal(x7, x7_ref) and torch.equal(vox7, vox7_ref), "row 2 at C = 7")
        g7 = torch.as_tensor(rng.normal(size=(B_SERVE, NP, 3 + K ** 3 * C7)).astype(np.float32),
                             device=dev)[..., 3:]
        dfv7 = table_gather_bwd(vox7, g7, GRID, K)
        check(torch.equal(dfv7, table_gather_bwd_ordered(vox7, g7, GRID, K)),
              "row 3 at C = 7: not the ordered plain sum")
        err_bwd7 = float((dfv7 - table_gather_bwd_plain(vox7, g7, GRID, K)).abs().max())
        check(err_bwd7 <= REL_BWD * float(dfv7.abs().max()), f"row 3 at C = 7: {err_bwd7}")
        q7_large = make_kernel_inputs(rng, torch, dev, B_SERVE)[1].repeat(1, NP_LARGE // NP, 1)
        vox7_large = voxel_assign(q7_large, GRID)[0]
        with torch.no_grad():
            p6 = table_gather(fv7, vox7_large, GRID, K)
            check(torch.equal(p6, table_gather_plain(fv7, vox7_large, GRID, K)), "row 6 at C = 7")
            _, m7, d7 = voxel_assign(q7, GRID)
            p10 = gather_patches_fused(fv7, vox7, m7, GRID, K)
            check(torch.equal(p10, gather_patches_fused_plain(fv7, vox7, m7, GRID, K)),
                  "row 10 at C = 7")
            # Row 9 over the 2B stack of the "full" route, on weights whose
            # outputs spread far beyond TOL_FF (the seeded init's do not:
            # its first layer's entries of ~2.6e-3 against FV entries of
            # ~0.04 leave every output within ~1e-3 of one value).
            fv9 = torch.as_tensor(rng.normal(0.0, C7_VOLUME_SD, (B_SERVE, G, C7))
                                  .astype(np.float32), device=dev)
            f16 = torch.cat([fv9, fv9.flip(0)]).to(torch.bfloat16)
            v2, d2 = torch.cat([vox7, vox7]), torch.cat([d7, d7])
            packed7 = pack_decoder(xavier_layers(rng, torch, dev, 3 + K ** 3 * C7, C7_WIDTHS))
            y9 = fused_forward(f16, v2, d2, packed7, GRID, K)
            y9_ref = fused_forward_plain(f16, v2, d2, packed7, GRID, K)
            # What a misplaced patch gives: each volume's channels rolled by one.
            y9_bad = fused_forward_plain(f16.roll(1, dims=-1), v2, d2, packed7, GRID, K)
        err_ff7 = float((y9 - y9_ref).abs().max())
        spread9 = float(y9_ref.max() - y9_ref.min())
        moved9 = float((y9_bad - y9_ref).abs().max())
        check(bool(torch.isfinite(y9).all()) and err_ff7 <= TOL_FF, f"row 9 at C = 7: {err_ff7}")
        check(spread9 >= 100 * TOL_FF, f"row 9 at C = 7: outputs spread only {spread9}")
        check(moved9 >= 10 * TOL_FF, f"row 9 at C = 7: a misplaced patch moves y by {moved9}")
        print(f"C = 7 at B = {B_SERVE}: rows 2, 6 and 10 exact; row 3 equal to the ordered plain "
              f"sum, {err_bwd7:.2e} from autograd's; row 9 at 2B = {2 * B_SERVE} (K = "
              f"{packed7.in_dim} -> {packed7.w[0].shape[1]}) {err_ff7:.2e} from its plain version "
              f"(tol {TOL_FF}), outputs spread over {spread9:.3f} (at least {100 * TOL_FF:.1f}), "
              f"a misplaced patch moves them by up to {moved9:.3f} (at least {10 * TOL_FF:.1f})",
              flush=True)
        del a7, q7, fv7, x7, x7_ref, g7, dfv7, p6, p10, fv9, f16, y9, y9_ref, y9_bad

    def variant_forward(params, state, cfg, a, b, **kw):
        with torch.no_grad():
            return forward_dpdist(params, state, cfg, a, b, **kw)[:2]

    def sampled(pred):
        return pred[:, ::vgold["stride"], 0].cpu().numpy()

    # Per variant, the kernel routes of the throughput forwards at B = 256:
    # (points per cloud, dtype, fused_gather, launches of one forward).
    VARIANT_FORWARDS = {
        "bn": [(NP, "float32", "auto", dict(mfv_gather_x=1)),
               (NP, "float32", "table", dict(table_gather_x=2))],
        "conv3": [(NP, "float32", "auto", dict(mfv_gather_x=1)),
                  (NP, "float32", "table", dict(table_gather_x=2))],
        "small_fv": [(NP, "float32", "auto", dict(table_gather_x=2)),
                     (NP_LARGE, "float32", "auto", dict(table_gather=2)),
                     (NP, "float32", "on", dict(gather_patches_fused=2)),
                     (NP, "bfloat16", "auto", dict(table_gather_x=2)),
                     (NP, "bfloat16", "full", dict(fused_forward=1))],
        "k0": [(NP_LARGE, "float32", "auto", dict(threedmfv=2)),
               (NP, "float32", "auto", {})],
        "pointnet": [(NP, "float32", "auto", {})],
        "dims2": [(NP, "float32", "auto", {})],
    }
    # The source gradients where a kernel runs: (points, launches, replays).
    VARIANT_GRADS = {
        "bn": [(NP, dict(table_gather_x=2, table_gather_bwd=1), 0)],
        "conv3": [(NP, dict(table_gather_x=2, table_gather_bwd=1), 0)],
        "small_fv": [(NP, dict(table_gather_x=2, table_gather_bwd=1), 0),
                     (NP_LARGE, dict(table_gather=2, table_gather_bwd=1), 0)],
        "k0": [(NP_LARGE, dict(threedmfv=2), 1)],
    }
    # Row-2 launches of one DPDist train step: with BN both directions.
    VARIANT_TRAIN = {"bn": 2, "conv3": 1, "pointnet": 0}
    variant_ms = {}

    with Phase("variants"), tempfile.TemporaryDirectory() as tmp:
        clouds64 = {3: requests[0], 2: tuple(x[..., :2].contiguous() for x in requests[0])}
        clouds256 = {3: requests_large[0]}
        for variant, want in vgold["variants"].items():
            t_var = time.perf_counter()
            cfg = DPDistConfig.from_json(want["config"])
            params, state = informative_weights(
                *init_dpdist(cfg, torch.Generator().manual_seed(vgold["seed"]), dev),
                want["perturb"])
            sums = {p: [float(t.double().sum()), float(t.double().square().sum())]
                    for p, t in tree_flatten_with_paths(params)}
            check(list(sums) == list(want["fingerprint"]), f"{variant}: weight tree")
            err_fp = max(abs(a - b) / max(abs(b), 1e-30) for p in sums
                         for a, b in zip(sums[p], want["fingerprint"][p]))
            print(f"{variant}: {cfg.to_json().replace(chr(10), '')}", flush=True)
            print(f"{variant}: {len(sums)} weight leaves, {sum(t.numel() for _, t in tree_flatten_with_paths(params))} "
                  f"weights, leaf sums " + ", ".join(f"{p} {s[0]:.6f}" for p, s in list(sums.items())[:4])
                  + f" ...; rel |d| to the golden file's {err_fp:.1e}", flush=True)
            check(err_fp <= 1e-9, f"{variant}: the seeded weights differ from the golden file's")
            spread = output_spread([want["pred_AB"], want["pred_BA"]])
            check(spread >= VARIANT_MIN_SPREAD * TOL_BF16,
                  f"{variant}: the golden outputs spread only {spread}")

            # The golden forwards (B = 4): float32 and bfloat16.
            gA4, gB4 = (torch.as_tensor(c, device=dev)
                        for c in variant_clouds(vgold["clouds"], cfg.dims))
            errs = []
            for dtype, mode, w, tol in ([("float32", "auto", want, TOL_DIST)]
                                        + [("bfloat16", m, w, TOL_BF16)
                                           for m, w in want["bf16"].items()]
                                        + [("float16", m, w, TOL_FP16)
                                           for m, w in want["fp16"].items()]):
                pAB, pBA = variant_forward(params, state, cfg.replace(dtype=dtype,
                                                                      fused_gather=mode), gA4, gB4)
                err = max(float(np.abs(sampled(p) - np.asarray(w[k])).max())
                          for p, k in ((pAB, "pred_AB"), (pBA, "pred_BA")))
                errs.append(f"{dtype} {mode} {err:.2e} (tol {tol})")
                check(err <= tol, f"{variant}: {dtype} {mode} forward vs golden: {err}")
            print(f"{variant}: golden forwards at B = {gA4.shape[0]} vs JAX: " + "; ".join(errs)
                  + f"; the golden outputs spread over {spread:.4f} (weights {want['perturb']})",
                  flush=True)

            # The throughput forwards at B = 256 against the plain path.
            for n_pts, dtype, mode, launches_want in VARIANT_FORWARDS[variant]:
                a, b = (clouds64 if n_pts == NP else clouds256)[cfg.dims]
                run_cfg = cfg.replace(dtype=dtype, fused_gather=mode)
                start_count()
                pAB, pBA = variant_forward(params, state, run_cfg, a, b)
                launched = read_count()
                rAB, rBA = variant_forward(params, state, run_cfg.replace(fused_gather="off"), a, b)
                err = max(float((pAB - rAB).abs().max()), float((pBA - rBA).abs().max()))
                tol = TOL_DIST if dtype == "float32" else TOL_BF16
                ms = cuda_median_ms(lambda: variant_forward(params, state, run_cfg, a, b),
                                    runs=5, warmup=1)
                plain_ms = cuda_median_ms(lambda: variant_forward(
                    params, state, run_cfg.replace(fused_gather="off"), a, b), runs=5, warmup=1)
                variant_ms[(variant, n_pts, dtype, mode)] = (ms, plain_ms)
                spread_ab = float(rAB[..., 0].max() - rAB[..., 0].min())
                print(f"{variant}: forward B = {a.shape[0]}, np = {n_pts}, {dtype} {mode}: kernel "
                      f"launches { {k: v for k, v in launched.items() if v} }, vs plain path max "
                      f"|d| {err:.2e} (tol {tol}; the plain path's AB outputs spread over "
                      f"{spread_ab:.4f}); {ms:.3f} ms, plain {plain_ms:.3f} ms "
                      f"({B_SERVE / ms * 1e3:.0f} pairs/s; CUDA-event median of 5); on {card}",
                      flush=True)
                check(launched == expected(**launches_want), f"{variant}: forward launches")
                check(bool(torch.isfinite(pAB).all() and torch.isfinite(pBA).all()),
                      f"{variant}: non-finite prediction")
                check(err <= tol, f"{variant}: {dtype} {mode} forward vs plain path: {err}")

            # The frozen loss's source gradient where a kernel runs.
            for n_pts, launches_want, replays in VARIANT_GRADS.get(variant, []):
                a, b = (clouds64 if n_pts == NP else clouds256)[cfg.dims]
                loss_fn = make_frozen_dpdist_loss(params, cfg, state=state)
                start_count()
                value, g = src_grad(loss_fn, a, b)
                launched = read_count()
                replayed = threedmfv_kernel.replays
                check(launched == expected(**launches_want), f"{variant}: source-gradient launches")
                check(replayed == replays, f"{variant}: encode replays")
                plain = make_frozen_dpdist_loss(params, cfg.replace(fused_gather="off"),
                                                state=state)
                v_ref, g_ref = src_grad(plain, a, b)
                d = abs(float(value - v_ref))
                worst = check_grad_rows(g, g_ref, f"{variant}: source gradient vs plain path")
                ms = cuda_median_ms(lambda: src_grad(loss_fn, a, b), runs=3, warmup=1)
                print(f"{variant}: source gradient B = {a.shape[0]}, np = {n_pts}: launches "
                      f"{ {k: v for k, v in launched.items() if v} }, replays "
                      f"{replayed}; vs plain path loss |d| {d:.2e}, d/dpcA worst "
                      f"point {worst:.2e} of max; {ms:.3f} ms a call", flush=True)
                check(d <= TOL_DIST, f"{variant}: frozen loss vs plain path: {d}")

            # DPDist training from the seeded weights on the golden batch, in
            # float32 and in float16 (a float16 decoder on float32 masters).
            trains = (("float32", "train", TOL_VARIANT_STEPS),
                      ("float16", "train_fp16", TOL_VARIANT_STEPS_FP16))
            for dtype, key, tols in trains if variant in VARIANT_TRAIN else ():
                gt = want[key]
                run_dir = os.path.join(tmp, f"{variant}_{dtype}")
                tr = DPDistTrainer(cfg.replace(dtype=dtype),
                                   TrainConfig(batch_size=vgold["train"]["batch_size"],
                                               augment=False, seed=vgold["seed"]),
                                   run_dir=run_dir, device=dev,
                                   logger=RunLogger(run_dir, echo=False))
                data, labels = dpdist_train_batch({"seed": gt["batch_seed"],
                                                   "batch_size": vgold["train"]["batch_size"],
                                                   "num_point": vgold["train"]["num_point"]})
                n_state = len(next(iter(gt["state"].values()), []))
                losses, gnorms, state_first = [], [], None
                for _ in range(len(gt["loss"])):
                    start_count()
                    m = tr.train_step(data, labels)
                    launched = read_count()
                    check(launched == expected(table_gather_x=VARIANT_TRAIN[variant]),
                          f"{variant}: {dtype} train step launches {launched}")
                    losses.append(float(m["loss"]))
                    gnorms.append(float(m["grad_norm"]))
                    if state_first is None:
                        state_first = state_sample(tr.state, n_state)
                first, later, gnorm_tol, state_first_tol, state_tol = tols
                err_first = abs(losses[0] - gt["loss"][0]) / gt["loss"][0]
                err_later = max(abs(a - b) / b for a, b in zip(losses[1:], gt["loss"][1:]))
                err_gn = abs(gnorms[0] - gt["grad_norm"][0]) / gt["grad_norm"][0]

                err_state_first = state_gap(state_first, gt["state_first"])
                err_state = state_gap(state_sample(tr.state, n_state), gt["state"])
                step_ms = cuda_median_ms(lambda: tr.train_step(data, labels), runs=3, warmup=0)
                print(f"{variant}: {len(losses)} {dtype} train steps at B = "
                      f"{vgold['train']['batch_size']}: "
                      f"losses {', '.join(f'{v:.6f}' for v in losses)} (JAX "
                      f"{', '.join(f'{v:.6f}' for v in gt['loss'])}); first rel |d| "
                      f"{err_first:.2e} (tol {first}), later {err_later:.2e} (tol {later}); "
                      f"first grad norm rel |d| {err_gn:.2e} (tol {gnorm_tol}; later "
                      f"{', '.join(f'{v:.4f}' for v in gnorms[1:])} vs "
                      f"{', '.join(f'{v:.4f}' for v in gt['grad_norm'][1:])}); BN state max |d| "
                      f"(of a leaf's largest entry above 1) after the first step "
                      f"{err_state_first:.2e} (tol {state_first_tol}), after the last "
                      f"{err_state:.2e} (tol {state_tol}); "
                      f"{VARIANT_TRAIN[variant]} row-2 launches "
                      f"a step; {step_ms:.3f} ms a step", flush=True)
                check(err_first <= first and err_later <= later and err_gn <= gnorm_tol
                      and err_state_first <= state_first_tol and err_state <= state_tol,
                      f"{variant}: {dtype} train steps off the golden ones")
                del tr
            del params, state
            torch.cuda.empty_cache()
            print(f"{variant}: {time.perf_counter() - t_var:.1f} s", flush=True)

    with Phase("dense"):
        # distance_field at 64^3 on a committed net for a 1,024-point surface:
        # the pretransformed path ("auto" at 262,144 queries) and the gather
        # path (row 6), each encoding the cloud by row 7.
        dg = vgold["dense"]
        dcfg, dnp, dstate_np = load_dpdist_checkpoint(str(ROOT / dg["net"]))
        dparams, dstate = params_from_jax(dnp, dev), params_from_jax(dstate_np, dev)
        cloud_np, q_np, d_index = dense_field_queries(dg["spec"])
        cloud = torch.as_tensor(cloud_np, device=dev)
        R = dg["spec"]["resolution"]
        q_all = torch.as_tensor(q_np[None], device=dev)
        start_count()
        with torch.no_grad():
            field = distance_field(dparams, dcfg, cloud, state=dstate, resolution=R,
                                   extent=dg["spec"]["extent"])
        launched_on = read_count()
        start_count()
        with torch.no_grad():
            d_off = dense_point_to_surface(dparams, dcfg, cloud, q_all, state=dstate,
                                           pretransform="off")
        launched_off = read_count()
        d_on = field.reshape(1, -1)
        err_paths = float((d_on - d_off).abs().max())
        idx = torch.as_tensor(d_index, device=dev)
        err_gold = max(float(np.abs(d[0, idx].cpu().numpy() - np.asarray(dg["values"])).max())
                       for d in (d_on, d_off))
        on_ms = cuda_median_ms(lambda: distance_field(dparams, dcfg, cloud, state=dstate,
                                                      resolution=R), runs=3, warmup=1)
        off_ms = cuda_median_ms(lambda: dense_point_to_surface(
            dparams, dcfg, cloud, q_all, state=dstate, pretransform="off"), runs=3, warmup=1)
        print(f"dense: {dg['net']}, {R}^3 = {q_all.shape[1]} queries against a "
              f"{cloud.shape[1]}-point surface: field {float(d_on.min()):.4f}..."
              f"{float(d_on.max()):.4f}; pretransform on vs off max |d| {err_paths:.2e} (tol "
              f"1e-5); both vs JAX's golden subsample ({len(d_index)} queries) max |d| "
              f"{err_gold:.2e} (tol {TOL_DIST}); launches on "
              f"{ {k: v for k, v in launched_on.items() if v} }, off "
              f"{ {k: v for k, v in launched_off.items() if v} }; {on_ms:.3f} ms "
              f"(pretransformed), {off_ms:.3f} ms (gather path), CUDA-event median of 3; "
              f"on {card}", flush=True)
        check(bool(torch.isfinite(d_on).all() and torch.isfinite(d_off).all()),
              "dense: non-finite distance")
        check(launched_on == expected(threedmfv=1), "dense: pretransformed launches")
        check(launched_off == expected(threedmfv=1, table_gather=1), "dense: gather launches")
        check(err_paths <= 1e-5, f"dense: pretransform on vs off {err_paths}")
        check(err_gold <= TOL_DIST, f"dense: vs golden {err_gold}")
        del field, d_off, d_on, q_all

    with Phase("serving_export"):
        # The frozen distance of results/ckpt_best as torch.export programs,
        # exported on the CPU beside the earlier phases, saved, loaded onto
        # the card: portable (plain ops, no launch) and native (the kernels
        # as dpdist:: ops, launching what `route` names), each against the
        # eager model on the first np = 64 requests.
        export_times = {}
        for part, proc in enumerate(exporters):
            rc = proc.wait(timeout=max(1.0, TIME_LIMIT_S - 20 - (time.perf_counter() - t_start)))
            log_tail = (export_path / f"export_{part}.log").read_text()[-3000:]
            check(rc == 0, f"export process {part} failed ({rc}):\n{log_tail}")
            export_times.update(json.loads((export_path / f"times_{part}.json").read_text()))
        print(f"exports (host, CPU, {len(exporters)} background processes of one thread, done "
              f"{time.perf_counter() - t_export:.1f} s after they started): "
              + ", ".join(f"{k} {v:.2f} s" for k, v in export_times.items()), flush=True)
        net0 = str(ROOT / NETS[0])
        eager = {"f32": load_frozen_distance(net0, device=dev),
                 "off": load_frozen_distance(net0, device=dev, fused_gather="off"),
                 "bf16_full": load_frozen_distance(net0, device=dev, dtype="bfloat16",
                                                   fused_gather="full"),
                 "bf16_off": load_frozen_distance(net0, device=dev, dtype="bfloat16",
                                                  fused_gather="off"),
                 "fp16": load_frozen_distance(net0, device=dev, dtype="float16")}
        programs = {}
        for name in SERVE_EXPORTS:
            programs[name] = load_exported(str(export_path / f"{name}.pt2"), device=dev).module()

        def eager_value_and_grad(model, a, b):
            a = a.detach().requires_grad_(True)
            d = model(a, b)
            return d.detach(), torch.autograd.grad(d.sum(), a)[0]

        # Per program: the launches its requests make, and the eager model
        # it is held against.
        want_launches = {
            "portable_f32": expected(), "portable_bf16": expected(),
            "portable_grad": expected(), "native_f32": expected(mfv_gather_x=REQUESTS),
            "native_bf16_full": expected(fused_forward=REQUESTS),
            "native_grad": expected(table_gather_x=2 * REQUESTS, table_gather_bwd=REQUESTS),
            "native_on": expected(gather_patches_fused=2 * REQUESTS),
            "native_f32_np256": expected(threedmfv=2 * REQUESTS, table_gather=2 * REQUESTS),
            "native_fp16": expected(mfv_gather_x=REQUESTS)}
        eager_of = {"portable_f32": "f32", "portable_bf16": "bf16_off", "portable_grad": "off",
                    "native_f32": "f32", "native_bf16_full": "bf16_full", "native_grad": "f32",
                    "native_on": "f32", "native_f32_np256": "f32", "native_fp16": "fp16"}
        serve_ms = {}
        for name, prog in programs.items():
            reqs = requests_large if SERVE_EXPORTS[name].get("num_point") else requests
            start_count()
            with torch.no_grad():
                outs = [prog(a, b) for a, b in reqs]
            launched = read_count()
            print(f"{name}: {REQUESTS} requests of {B_SERVE} pairs at np={reqs[0][0].shape[1]}, "
                  f"kernel launches { {k: v for k, v in launched.items() if v} }", flush=True)
            check(launched == want_launches[name], f"{name}: unexpected launches")
            ref_model = eager[eager_of[name]]
            if SERVE_EXPORTS[name].get("with_grad"):
                err_v = err_g = 0.0
                for (a, b), (vals, grads) in zip(reqs, outs):
                    want_v, want_g = eager_value_and_grad(ref_model, a, b)
                    check(vals.shape == (B_SERVE,) and grads.shape == a.shape
                          and bool(torch.isfinite(grads).all()), f"{name}: bad outputs")
                    err_v = max(err_v, float((vals - want_v).abs().max()))
                    err_g = max(err_g, check_grad_rows(grads, want_g, f"{name}: d/dsrc"))
                print(f"{name}: values vs the eager frozen loss max |d| {err_v:.3e} (tol "
                      f"{TOL_DIST}); d/dsrc worst point {err_g:.3e} of max (tol {REL_GRAD} on "
                      f"all but {OUTLIERS}, {REL_GRAD_FEW} on all)", flush=True)
                check(err_v <= TOL_DIST, f"{name}: values off the eager loss by {err_v}")
            else:
                tol = TOL_BF16 if "bf16" in name else TOL_FP16 if "fp16" in name else TOL_DIST
                with torch.no_grad():
                    err = max(float((o - ref_model(a, b)).abs().max())
                              for o, (a, b) in zip(outs, reqs))
                check(all(o.shape == (B_SERVE,) and bool(torch.isfinite(o).all())
                          for o in outs), f"{name}: bad outputs")
                print(f"{name}: vs the eager model max |d| {err:.3e} (tol {tol})", flush=True)
                check(err <= tol, f"{name}: off the eager model by {err}")
            a, b = reqs[0]
            with torch.no_grad():
                serve_ms[name] = [cuda_median_ms(lambda: prog(a[:n], b[:n]), runs=SERVE_TIMED_RUNS,
                                                 warmup=2)
                                  for n in (1, SERVE_TIMED_BATCH)]
        print(f"served calls (np=64 but for np256), ms at B=1 / B={SERVE_TIMED_BATCH} (CUDA "
              f"events, median of {SERVE_TIMED_RUNS}): " + "; ".join(
                  f"{k} " + " / ".join(f"{t:.3f}" for t in v) for k, v in serve_ms.items())
              + f"; on {card}", flush=True)
        del eager, programs

    with Phase("serving_registration"):
        # The production policy under its protocol (50 iterations, the
        # period0 stop), fixed-length and early exit, against the eager
        # refinement and stop; then export_serving -> run_serving.
        fixed = load_exported(str(export_path / "policy_fixed.pt2"), device=dev).module()
        early = load_exported(str(export_path / "policy_early.pt2"), device=dev).module()
        policy = params_to_device(policy_np, dev)
        tpl, src, _ = (torch.as_tensor(x, device=dev)
                       for x in production_cases().sample_batch(SERVE_TIMED_BATCH))
        with torch.no_grad():
            _, _, poses = pcrnet_refine(policy, pcfg, src, tpl, iterations=REG_ITERATIONS,
                                        stop_gradient_iters=False)
            T_total, _, _, frozen, conv_iter = registration.accumulate_with_stopping(
                poses, src, tpl, **REG_STOP)
            want = (invert_transform(T_total), apply_transform(src, T_total))
            start_count()
            got = {"fixed": fixed(tpl, src), "early": early(tpl, src)}
            got1 = {"fixed": fixed(tpl[:1], src[:1]), "early": early(tpl[:1], src[:1])}
            launched = read_count()
        check(sum(launched.values()) == 0, f"the policy programs launched kernels: {launched}")
        for n, g in ((SERVE_TIMED_BATCH, got), (1, got1)):
            check(all(torch.equal(x, y) for x, y in zip(g["fixed"], g["early"])),
                  f"policy at B={n}: early exit differs from the fixed-length loop")
        err_T = float((got["fixed"][0] - want[0]).abs().max())
        err_al = float((got["fixed"][1] - want[1]).abs().max())
        err_T1 = float((got1["fixed"][0] - want[0][:1]).abs().max())
        trips = int(conv_iter.max()) + 1 if bool(frozen.all()) else REG_ITERATIONS
        trips1 = int(conv_iter[0]) + 1 if bool(frozen[0]) else REG_ITERATIONS
        print(f"policy at B={SERVE_TIMED_BATCH}: early exit equal to the fixed-length loop (B=1 "
              f"too); vs eager pcrnet_refine + accumulate_with_stopping: T_pred max |d| "
              f"{err_T:.3e}, aligned {err_al:.3e}, B=1 T_pred {err_T1:.3e} (tol {TOL_POLICY}); "
              f"{int(frozen.sum())} of {SERVE_TIMED_BATCH} frozen, the loop's trips {trips} at "
              f"B={SERVE_TIMED_BATCH}, {trips1} at B=1 (eager conv_iter); no kernel launched",
              flush=True)
        check(max(err_T, err_al, err_T1) <= TOL_POLICY, "policy program off the eager policy")
        with torch.no_grad():
            pol_ms = {k: [cuda_median_ms(lambda: prog(tpl[:n], src[:n]), runs=5, warmup=1)
                          for n in (1, SERVE_TIMED_BATCH)]
                      for k, prog in (("fixed", fixed), ("early", early))}
        print(f"policy programs, ms at B=1 / B={SERVE_TIMED_BATCH} (CUDA events, median of 5): "
              + "; ".join(f"{k} {v[0]:.2f} / {v[1]:.2f}" for k, v in pol_ms.items())
              + f"; on {card}", flush=True)
        cli_line = json.loads((export_path / "policy_cli.json").read_text().strip()
                              .splitlines()[-1])
        check(cli_line["inputs"] == [[CLI_POLICY_BATCH, pcfg.num_point, 3]] * 2,
              f"export_serving: {cli_line}")
        with contextlib.redirect_stdout(io.StringIO()):
            res = run_serving_cli.main(["--artifact", str(export_path / "policy_cli.pt2"),
                                        "--synthetic", "chair", "--bench", "20",
                                        "--device", "cuda"])
        check(res["batch"] == CLI_POLICY_BATCH and res["num_point"] == pcfg.num_point
              and bool(np.isfinite(np.asarray(res["T_pred"])).all()), f"run_serving: {res}")
        print(f"export_serving -> run_serving --synthetic chair --bench 20: {cli_line['bytes']} "
              f"bytes, batch {res['batch']}, first call {res['first_call_ms']} ms, "
              f"{res['bench_ms_per_call']} ms a call; on {card}", flush=True)
        del fixed, early, policy

    with Phase("serving_registration_3dmfv"):
        # The 3dmfv policy at full width (policy3) under REG_STOP at 50
        # iterations. Row 7 first, on this path's clouds at B = 64 and 1,
        # against the plain encode. Then three programs exported on the CPU
        # in the background: native (row 7's op encodes the hoisted template
        # once and the source on every trip of the loop) fixed-length and
        # early exit, and portable (the plain encode) fixed-length. Each is
        # held against the eager refinement and stop on the card at the same
        # batch and on its route: native against the eager path (row 7),
        # portable against the eager path routed as a portable export routes
        # it (ops.exporting("portable"): the plain encode). The two routes'
        # gap and the gap between batches of 64 and 1 are printed beside the
        # spread of T_pred: a random policy amplifies rounding over 50 trips.
        from dpdist_tpu_torch.kernels import ops as kernel_ops

        pcfg3, p3, s3 = policy3(dev)
        tpl3, src3, _ = (torch.as_tensor(x, device=dev).contiguous() for x in RegistrationDataset(
            pose_file=default_eval_poses(), num_point=pcfg3.num_point,
            **REG_MF).sample_batch(SERVE_TIMED_BATCH))
        batches = (SERVE_TIMED_BATCH, 1)
        G3, sigma3, N3 = pcfg3.mfv_grid ** 3, pcfg3.sigma3dmfv, pcfg3.num_point
        err7, ms7 = 0.0, {}
        with torch.no_grad():
            for n in batches:
                for pts in (tpl3[:n], src3[:n]):
                    fv7 = threedmfv_kernel(pts, G3, sigma3)
                    check(fv7.shape == (n, G3, C) and bool(torch.isfinite(fv7).all()),
                          f"row 7 at B={n}, N={N3}: bad encode")
                    err7 = max(err7, float((fv7 - threedmfv_plain(pts, G3, sigma3)).abs().max()))
                # Points and Gaussian centres in, the volumes out.
                ms7[n] = (cuda_median_ms(lambda: threedmfv_kernel(src3[:n], G3, sigma3)),
                          cuda_median_ms(lambda: threedmfv_plain(src3[:n], G3, sigma3)),
                          *bound(4 * (n * N3 * 3 + G3 * 3 + n * G3 * C),
                                 ENCODE_OPS_PER_PAIR * n * N3 * G3))
        print(f"row 7 on this path's clouds (template and source, N={N3}, {G3} Gaussians, sigma "
              f"{sigma3}) vs the plain encode: max |d fv| {err7:.3e} (tol {TOL_X}); ms (CUDA "
              f"events, median of {TIMED_RUNS}): " + "; ".join(
                  f"B={n} kernel {v[0]:.4f}, plain {v[1]:.4f}, bound {v[2]:.4f} ({v[3]})"
                  for n, v in ms7.items()) + f"; on {card}", flush=True)
        check(err7 <= TOL_X, f"row 7 on the 3dmfv policy's clouds: max |d fv| {err7} > {TOL_X}")

        progs3 = {k: load_exported(str(export_path / f"policy3_{k}.pt2"), device=dev).module()
                  for k in POLICY3_PROGRAMS}

        def eager3(n):
            """(T_pred, aligned, frozen, conv_iter) of the eager policy on the
            first n cases."""
            _, _, poses = pcrnet_refine(p3, pcfg3, src3[:n], tpl3[:n], iterations=REG_ITERATIONS,
                                        stop_gradient_iters=False, state=s3)
            T, _, _, frozen, conv_iter = registration.accumulate_with_stopping(
                poses, src3[:n], tpl3[:n], **REG_STOP)
            return invert_transform(T), apply_transform(src3[:n], T), frozen, conv_iter

        with torch.no_grad():
            want3 = {("native", n): eager3(n) for n in batches}
            with kernel_ops.exporting("portable"):
                want3.update({("portable", n): eager3(n) for n in batches})
            # One checked call of each program at each batch, counted; then
            # the timed calls.
            got3, launched3 = {}, {}
            for k, prog in progs3.items():
                start_count()
                for n in batches:
                    got3[k, n] = prog(tpl3[:n], src3[:n])
                launched3[k] = read_count()
            ms3 = {k: [cuda_median_ms(lambda: prog(tpl3[:n], src3[:n]), runs=POLICY3_TIMED_RUNS,
                                      warmup=0) for n in (1, SERVE_TIMED_BATCH)]
                   for k, prog in progs3.items()}
        frozen3, conv3 = want3["native", SERVE_TIMED_BATCH][2:]
        trips = int(conv3.max()) + 1 if bool(frozen3.all()) else REG_ITERATIONS
        trips1 = int(conv3[0]) + 1 if bool(frozen3[0]) else REG_ITERATIONS
        # Row 7 a call: the hoisted template's encode, then one a trip.
        want_launches3 = {"native_fixed": 2 * (REG_ITERATIONS + 1),
                          "native_early": trips + trips1 + 2, "portable_fixed": 0}
        print(f"3dmfv policy programs: row-7 launches of the checked calls at "
              f"B={SERVE_TIMED_BATCH} and 1: "
              + ", ".join(f"{k} {v['threedmfv']}" for k, v in launched3.items())
              + f" ({int(frozen3.sum())} of {SERVE_TIMED_BATCH} cases frozen, the early loop's "
              f"trips {trips} at B={SERVE_TIMED_BATCH}, {trips1} at B=1)", flush=True)
        for k in POLICY3_PROGRAMS:
            check(launched3[k] == expected(threedmfv=want_launches3[k]),
                  f"3dmfv policy {k}: unexpected launches")
            check(all(bool(torch.isfinite(o).all()) for n in batches for o in got3[k, n]),
                  f"3dmfv policy {k}: non-finite outputs")
        for n in batches:
            check(all(torch.equal(x, y) for x, y in zip(got3["native_fixed", n],
                                                        got3["native_early", n])),
                  f"3dmfv policy at B={n}: early exit differs from the fixed loop")

        def gap(a, b):
            return max(float((x - y).abs().max()) for x, y in zip(a[:2], b[:2]))

        err3 = {kind: max(gap(got3[f"{kind}_fixed", n], want3[kind, n]) for n in batches)
                for kind in ("native", "portable")}
        route_gap = max(gap(want3["native", n], want3["portable", n]) for n in batches)
        batch_gap = gap(want3["native", 1], [w[:1] for w in want3["native", SERVE_TIMED_BATCH]])
        T64 = want3["native", SERVE_TIMED_BATCH][0]
        spread3 = float((T64.amax(0) - T64.amin(0)).max())
        print(f"3dmfv policy (num_point {N3}, {pcfg3.mfv_grid}^3 grid, "
              f"out_features {pcfg3.out_features}, BN state, {REG_ITERATIONS} iterations, "
              f"{REG_STOP['stop_select']} stop): native early exit equal to the fixed-length "
              f"loop at B={SERVE_TIMED_BATCH} and 1; T_pred and aligned max |d| vs eager "
              f"pcrnet_refine + accumulate_with_stopping on the program's route at its batch: "
              f"native {err3['native']:.3e}, portable {err3['portable']:.3e} (tol "
              f"{TOL_POLICY}); T_pred's spread over the batch {spread3:.3e} (must exceed the "
              f"tolerance); for scale, the eager paths' gaps over {REG_ITERATIONS} trips: plain "
              f"encode vs row 7 {route_gap:.3e}, B=1 vs row 0 of B={SERVE_TIMED_BATCH} "
              f"{batch_gap:.3e}; max |T_pred| {float(T64.abs().max()):.3f}", flush=True)
        check(err3["native"] <= TOL_POLICY, "3dmfv native program off the eager policy")
        check(err3["portable"] <= TOL_POLICY, "3dmfv portable program off the eager policy")
        check(spread3 > TOL_POLICY, "3dmfv policy: T_pred does not spread over the batch by "
              "more than the tolerance, so it cannot fail")
        print(f"3dmfv policy programs, ms at B=1 / B={SERVE_TIMED_BATCH} (CUDA events, median of "
              f"{POLICY3_TIMED_RUNS}, after the checked calls): "
              + "; ".join(f"{k} {v[0]:.2f} / {v[1]:.2f}" for k, v in ms3.items())
              + "; exported in " + ", ".join(f"{k} {export_times[f'policy3_{k}']:.2f} s"
                                              for k in POLICY3_PROGRAMS)
              + f" (host CPU); on {card}", flush=True)
        cli3 = json.loads((export_path / "policy3_cli.json").read_text().strip()
                          .splitlines()[-1])
        check(cli3["inputs"] == [[POLICY3_CLI_BATCH, pcfg3.num_point, 3]] * 2
              and cli3["native_kernels"], f"export_serving (3dmfv): {cli3}")
        start_count()
        with contextlib.redirect_stdout(io.StringIO()):
            res3 = run_serving_cli.main(["--artifact", str(export_path / "policy3_cli.pt2"),
                                         "--synthetic", "chair", "--device", "cuda"])
        launched_cli3 = read_count()
        check(res3["batch"] == POLICY3_CLI_BATCH and res3["num_point"] == pcfg3.num_point
              and bool(np.isfinite(np.asarray(res3["T_pred"])).all()),
              f"run_serving (3dmfv): {res3}")
        # One call: the template's encode and one a trip of the early loop.
        check(launched_cli3 == expected(threedmfv=launched_cli3["threedmfv"])
              and 2 <= launched_cli3["threedmfv"] <= REG_ITERATIONS + 1,
              f"run_serving (3dmfv): unexpected launches {launched_cli3}")
        print(f"export_serving --pcrnet_ckpt (a 3dmfv checkpoint with its BN state, "
              f"--native_kernels, batch {POLICY3_CLI_BATCH}, "
              f"{export_times['policy3_cli']:.2f} s) -> run_serving --synthetic chair: "
              f"{cli3['bytes']} bytes, T_pred finite, one call {res3['first_call_ms']} ms, "
              f"row-7 launches {launched_cli3['threedmfv']}; on {card}", flush=True)
        del progs3, got3, want3, p3, s3
    export_dir.cleanup()

    with Phase("data_parallel"), tempfile.TemporaryDirectory() as tmp:
        import torch.distributed as dist

        from dpdist_tpu_torch.parallel import initialize_distributed, make_mesh

        # The two gloo processes start first (they take seconds to import
        # and reach the card) on inputs written here: the global batch of
        # the canonical step, and the 64^3 field's cloud and queries.
        check(dg["net"] == NETS[0], f"the dense phase's net {dg['net']} is not {NETS[0]}")
        dp_dir = Path(tmp)
        dp_data, dp_labels = make_train_batch(rng, torch, dev, batch=DP_WORLD * DP_LOCAL_BATCH)
        np.savez(dp_dir / "inputs.npz", data=dp_data, labels=dp_labels, cloud=cloud_np,
                 queries=q_np[None])
        workers = []
        for r in range(DP_WORLD):
            with open(dp_dir / f"worker{r}.log", "w") as log:
                workers.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), "--dp-worker", str(r),
                     str(dp_dir)], stdout=log, stderr=subprocess.STDOUT, cwd=str(ROOT),
                    env={**os.environ, "LOCAL_RANK": "0"}))
        _children.extend(workers)

        # World size 1 on NCCL.
        check(initialize_distributed(f"file://{dp_dir / 'nccl_store'}", 1, 0, device="cuda"),
              "initialize_distributed did not start a group")
        check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
        mesh1 = make_mesh(device="cuda")
        data256, labels256 = make_train_batch(rng, torch, dev, batch=B_SERVE)
        tcfg256 = TrainConfig(batch_size=B_SERVE, augment=False)

        def dp_trainer(mesh=None):
            return DPDistTrainer(DPDistConfig(), tcfg256, run_dir=os.path.join(tmp, "t"),
                                 mesh=mesh, logger=RunLogger(os.path.join(tmp, "t"), echo=False),
                                 device=dev)

        # Every trainer step is the sharded step; on the world's 1 x 1 mesh
        # it makes no collective and must equal the step with no mesh.
        plain_tr, mesh_tr = dp_trainer(), dp_trainer(mesh1)
        start_count()
        m_plain = plain_tr.train_step(data256, labels256)
        launched_plain = read_count()
        start_count()
        m_mesh = mesh_tr.train_step(data256, labels256)
        launched_mesh = read_count()
        same_params = all(torch.equal(a, b) for a, b in zip(
            flat_params(plain_tr.params).values(), flat_params(mesh_tr.params).values()))
        same = (torch.equal(m_plain["loss"], m_mesh["loss"])
                and torch.equal(m_plain["grad_norm"], m_mesh["grad_norm"]) and same_params)
        print(f"data_parallel, NCCL at world size 1: canonical step at B={B_SERVE} on the "
              f"world's 1 x 1 mesh vs no mesh: loss {float(m_mesh['loss']):.7f} / "
              f"{float(m_plain['loss']):.7f}, grad norm {float(m_mesh['grad_norm']):.6f} / "
              f"{float(m_plain['grad_norm']):.6f}, params and metrics equal bit for bit: "
              f"{same}; launches {launched_mesh} / {launched_plain}", flush=True)
        check(same, "the step on the 1 x 1 mesh differs from the step with no mesh")
        check(launched_plain == launched_mesh == expected(table_gather_x=1),
              "data_parallel: unexpected launches of the canonical step")
        # The step's all_reduce over one NCCL rank, on the flat buffer of the
        # loss and the gradients that a data axis of n > 1 reduces: exact.
        loss_g, grads_g = plain_tr.loss_and_grads(*plain_tr.make_batch(data256, labels256))
        buf = torch.cat([loss_g.reshape(1), *(g.reshape(-1) for g in grads_g)])
        reduced = buf.clone()
        dist.all_reduce(reduced)
        check(torch.equal(reduced, buf), "data_parallel: the all_reduce over one rank moved "
              "the gradients")
        turns = {"no mesh": [], "1 x 1 mesh": []}
        for name_ in ("no mesh", "1 x 1 mesh", "1 x 1 mesh", "no mesh"):
            fn = {"no mesh": lambda: plain_tr.train_step(data256, labels256),
                  "1 x 1 mesh": lambda: mesh_tr.train_step(data256, labels256)}[name_]
            turns[name_].append(cuda_median_ms(fn, runs=DP_TIMED_RUNS, warmup=2))
        reduce_ms = cuda_median_ms(lambda: dist.all_reduce(reduced), runs=DP_TIMED_RUNS,
                                   warmup=2)
        print(f"data_parallel: canonical train step at B={B_SERVE} f32 (dataset batch in, "
              f"CUDA-event medians of {DP_TIMED_RUNS}, in turns A B B A), ms: " + "; ".join(
                  f"{k} {v[0]:.4f}, {v[1]:.4f}" for k, v in turns.items())
              + f"; the step's all_reduce alone ({buf.numel()} f32, "
              f"{buf.numel() * 4 / 1e6:.1f} MB, exact over one rank) {reduce_ms:.4f} ms; "
              f"on {card}", flush=True)
        del plain_tr, mesh_tr, buf, reduced, grads_g

        # The production PCRNet step on the frozen loss on the world's 1 x 1
        # mesh, on train_pcrnet's first batch.
        tmpl_dp, src_dp, pose6_dp = RegistrationDataset(
            num_point=pcfg.num_point, **REG_RECIPE).sample_batch(
                PCR_BATCH, random_points_prob=1.0, noise_prob=1.0)
        pcr_plain, pcr_mesh = pcr_trainer("dp_plain"), pcr_trainer("dp_mesh", mesh=mesh1)
        for t in (pcr_plain, pcr_mesh):
            t.restore(str(ROOT / POLICY))
        start_count()
        mp_ = pcr_plain.train_step(tmpl_dp, src_dp, pose6_dp)
        launched_pcr_plain = read_count()
        start_count()
        ms_ = pcr_mesh.train_step(tmpl_dp, src_dp, pose6_dp)
        launched_pcr = read_count()
        err_pcr = abs(float(ms_["loss"]) - float(mp_["loss"])) / float(mp_["loss"])
        err_pcr_gn = abs(float(ms_["grad_norm"]) - float(mp_["grad_norm"])) / float(
            mp_["grad_norm"])
        lr_pcr = ptcfg.learning_rate
        pcr_off = [float((a - b).abs().max()) for a, b in zip(
            flat_params(pcr_plain.params).values(), flat_params(pcr_mesh.params).values())]
        print(f"data_parallel: production PCRNet step (B={PCR_BATCH}, full BPTT, frozen loss) "
              f"on the world's 1 x 1 mesh vs no mesh: loss rel |d| {err_pcr:.2e} (tol "
              f"{TOL_PCR_LOSS}), grad norm rel |d| {err_pcr_gn:.2e}, params max |d| "
              f"{max(pcr_off):.2e} (Adam's first step, tol 2 lr = {2 * lr_pcr:.0e}); launches "
              f"{launched_pcr} / {launched_pcr_plain}", flush=True)
        check(err_pcr <= TOL_PCR_LOSS and max(pcr_off) <= 2 * lr_pcr + 1e-6,
              "data_parallel: the PCRNet step on the 1 x 1 mesh differs from the step with "
              "no mesh")
        check(launched_pcr == launched_pcr_plain == per_step,
              "data_parallel: unexpected PCRNet launches")
        del pcr_plain, pcr_mesh

        # The 64^3 field on the world's mesh (1 x 1: the single-device path).
        q_field = torch.as_tensor(q_np[None], device=dev)
        start_count()
        with torch.no_grad():
            field1 = dense_point_to_surface(dparams, dcfg, cloud, q_field, state=dstate,
                                            mesh=mesh1, pretransform="off")
        launched_field1 = read_count()
        check(launched_field1 == expected(threedmfv=1, table_gather=1),
              f"data_parallel: field launches {launched_field1}")
        dist.destroy_process_group()

        # The single-process step on the whole batch of the two processes.
        whole = dp_trainer()
        m_whole = whole.train_step(dp_data, dp_labels)
        whole_params = {p: t.cpu().clone().numpy() for p, t in flat_params(whole.params).items()}
        try:
            for w in workers:
                w.wait(timeout=DP_WORKER_TIMEOUT_S)
        finally:
            for w in workers:
                if w.poll() is None:
                    w.kill()
        for r, w in enumerate(workers):
            if w.returncode != 0:
                print((dp_dir / f"worker{r}.log").read_text()[-4000:], flush=True)
            check(w.returncode == 0, f"dp worker {r} exited with {w.returncode}")
        res = [json.loads((dp_dir / f"rank{r}.json").read_text()) for r in range(DP_WORLD)]
        arrs = [np.load(dp_dir / f"rank{r}.npz") for r in range(DP_WORLD)]
        loss_w = float(m_whole["loss"])
        lr = tcfg256.learning_rate
        off = total = 0
        worst = 0.0
        for p, want in whole_params.items():
            got = arrs[0][p]
            check(np.array_equal(got, arrs[1][p]), f"dp: params {p} differ between processes")
            worst = max(worst, float(np.abs(got - want).max()))
            off += int((np.abs(got - want) > 1e-6).sum())
            total += want.size
        loss_ok = abs(res[0]["loss"] - loss_w) <= DP_LOSS_ATOL + DP_LOSS_RTOL * abs(loss_w)
        fields = [a["field"] for a in arrs]
        err_field = float(np.abs(fields[0] - field1.cpu().numpy()).max())
        print(f"data_parallel, {DP_WORLD} processes on the one card over gloo: canonical step "
              f"at B={DP_LOCAL_BATCH} a process: loss {res[0]['loss']:.7f} / "
              f"{res[1]['loss']:.7f} against {loss_w:.7f} for the single-process step on the "
              f"{DP_WORLD * DP_LOCAL_BATCH}-pair batch (rtol {DP_LOSS_RTOL}), grad norm "
              f"{res[0]['grad_norm']:.6f} / {float(m_whole['grad_norm']):.6f}; params equal "
              f"between processes, {worst:.2e} max |d| from the whole step (tol 2 lr), "
              f"{off} of {total} off by more than 1e-6; step {res[0]['step_ms']:.3f} / "
              f"{res[1]['step_ms']:.3f} ms (CUDA-event medians of {DP_TIMED_RUNS}); launches "
              f"{[r_['launches']['step'] for r_ in res]}", flush=True)
        check(loss_ok and res[0]["loss"] == res[1]["loss"], "dp: loss off the whole step")
        check(worst <= 2 * lr + 1e-6 and off < 0.01 * total, "dp: params off the whole step")
        print(f"data_parallel: the 64^3 field sharded over the points axis of {DP_WORLD} "
              f"processes (pretransform off): gathered fields equal on both: "
              f"{np.array_equal(fields[0], fields[1])}; vs the unsharded field max |d| "
              f"{err_field:.2e} (tol {DP_TOL_FIELD}); {res[0]['field_ms']:.3f} / "
              f"{res[1]['field_ms']:.3f} ms a call (median of 3); launches "
              f"{[r_['launches']['field'] for r_ in res]}; mesh indices "
              f"{[r_['mesh'] for r_ in res]}; on {card}", flush=True)
        check(np.array_equal(fields[0], fields[1]) and err_field <= DP_TOL_FIELD,
              "dp: the sharded field is off the unsharded one")
        for r_ in res:
            check(r_["launches"]["step"] == {"table_gather_x": 1, "table_gather": 0,
                                              "threedmfv": 0}, "dp: worker step launches")
            check(r_["launches"]["field"] == {"table_gather_x": 0, "table_gather": 1,
                                               "threedmfv": 1}, "dp: worker field launches")
            for part in r_["launches"].values():
                for k, v in part.items():
                    launches[k] += v
        check([r_["mesh"] for r_ in res] == [[r, r] for r in range(DP_WORLD)],
              "dp: mesh indices")
        del whole, arrs, fields, field1

    for r in records:
        r["launches"] = launches[r["name"]]

    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    signal.alarm(0)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--export-artifacts":
        sys.exit(export_artifacts(Path(sys.argv[2]), int(sys.argv[3])))
    if len(sys.argv) == 4 and sys.argv[1] == "--dp-worker":
        sys.exit(dp_worker(int(sys.argv[2]), Path(sys.argv[3])))
    try:
        sys.exit(main())
    finally:
        _stop_children()
