"""dpdist_tpu_torch: the DPDist learned distance in PyTorch and CUDA.

A port of `dpdist_tpu` (JAX on a TPU) to PyTorch on an NVIDIA H100. The
module layout mirrors `dpdist_tpu/`, so each port module sits at the path
of its reference. This package imports neither `jax` nor `dpdist_tpu`.

Slices covered so far: the frozen DPDist distance served from the
committed checkpoints, its gradient in the input clouds (the frozen
loss), and DPDist training on one device.

  configs/    DPDistConfig, TrainConfig (same fields, defaults and JSON form)
  train/      checkpoints (read and write), optimizer, run logger, trainer
  ops/        3DmFV encode and voxel ops, plain PyTorch
  kernels/    kernel wrappers: plain version, launch counter, ctypes binding
  csrc/       the hand-written CUDA kernels (sm_90a)
  nn/         dense / MLP decoder, initialisers, LR and BN schedules
  models/     DPDist init, forward and distance
  losses/     the frozen DPDist loss, the l1 training loss
  data/       synthetic surfaces, batch assembly, prefetching (numpy)
  cli/        eval_pair
  serving.py  load_frozen_distance: the served nn.Module

Entry points run on the card (`device="cuda"`) unless the caller asks for
the CPU; without a card they raise.

Numerics: float32 everywhere, with TF32 switched off for matmuls and
convolutions. The JAX package pins HIGHEST matmul precision because
lower precision moved its accuracy cells; TF32 is the same hazard on
Hopper, so importing this package sets both flags to False.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

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
