"""dpdist_tpu_torch: the DPDist learned distance in PyTorch and CUDA.

A port of `dpdist_tpu` (JAX on a TPU) to PyTorch on an NVIDIA H100. The
module layout mirrors `dpdist_tpu/`, so each port module sits at the path
of its reference. This package imports neither `jax` nor `dpdist_tpu`.

Slices covered so far: the frozen DPDist distance served from the
committed checkpoints (float32, and bfloat16 through the fused
gather + decoder kernel or the composed bf16 path), its gradient in the
input clouds (the frozen loss, float32 or bfloat16), DPDist training on
one device (float32 or bfloat16) from the command line, registration:
the iterative PCRNet policy (pointnet and 3dmfv encoders), its evaluator
with the convergence stops, and PCRNet training on the frozen DPDist loss,
chamfer or EMD; the point-cloud autoencoder trained on the frozen
loss or chamfer, with kNN, the blocked EMD and the distance comparison;
and the whole DPDist model family (BN and conv_version=3 decoders, the
7-channel encode, the global k=0 embedding, the pointnet encoder, 2-D)
with dense evaluation (distance fields).

  configs/    DPDistConfig, AUEConfig, PCRNetConfig, TrainConfig (same
              fields, defaults and JSON form)
  train/      checkpoints (read and write), optimizer, run logger, the DPDist,
              PCRNet and AUE trainers, profiling hooks
  geometry/   rotations, SE(3) transforms, symmetry-aware errors
  eval/       the registration evaluator, the distance comparison, dense
              evaluation (distance fields), plots and views
  ops/        3DmFV encode, voxel ops, chamfer, EMD (dense and blocked), kNN
  kernels/    kernel wrappers: plain version, launch counter, ctypes binding
  csrc/       the hand-written CUDA kernels (sm_90a)
  nn/         dense, conv, pool and BN layers, the MLP, initialisers, LR and
              BN schedules
  models/     DPDist init, forward and distance; the PCRNet policy; the AUEs
  losses/     the frozen DPDist loss, the l1 training loss
  data/       synthetic surfaces, the surface-pair dataset, ground-truth
              generation, augmentations, file formats, batch assembly,
              prefetching, registration templates and poses (numpy; gtgen's
              distances on the card)
  native/     the native host library (C++, built with g++ at first use)
  cli/        eval_pair, gen_data, train_dpdist, train_pcrnet,
              eval_registration, eval_matrix, make_templates, train_aue,
              compare_losses
  serving.py  load_frozen_distance: the served nn.Module

Entry points run on the card (`device="cuda"`) unless the caller asks for
the CPU; without a card they raise.

Numerics: float32 unless a config asks for bfloat16, with TF32 switched
off for matmuls and convolutions. The JAX package pins HIGHEST matmul
precision because lower precision moved its accuracy cells; TF32 is the
same hazard on Hopper, so importing this package sets both flags to
False. bfloat16 products accumulate in float32, as the reference's
(preferred_element_type=float32); cuBLAS may otherwise reduce a bf16
GEMM in bf16, so importing the package also switches that off.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

__version__ = "0.1.0"


def resolve_device(device) -> torch.device:
    """Return `device` as a torch.device; raise if it names CUDA and no
    card is present (entry points never carry on on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device=%r requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path" % str(device))
    return dev
