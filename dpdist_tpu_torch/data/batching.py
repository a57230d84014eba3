"""Training-batch assembly for DPDist (port of dpdist_tpu/data/batching.py;
numpy, byte-identical to the reference's batches).

The reference's train_one_epoch_3d with dataset npoints = 2*NUM_POINT:

  batch_data (B, 3*2N, 3) = [surface(2N), near(2N), far(2N)]
  labels     (B, 2*2N)    = [near_d(2N), far_d(2N)]

  S_A, S_B = split(surface, 2)          # two same-surface samples, N each
  pcA = S_A                                              (N)
  pcB = [S_B[:N/2], near[:N/4], far[N/4:N/2]]            (N)
  labels_AB = [zeros(N/2), near_d[:N/4], far_d[N/4:N/2]] (N)

so half of B's points lie on the surface (label 0), a quarter near it, and
a quarter are far/uniform, with ground-truth distances from the generator.
"""

from __future__ import annotations

import numpy as np


def assemble_dpdist_batch(batch_data: np.ndarray, batch_labels: np.ndarray):
    """(B, 6N, 3), (B, 4N) -> pcA (B, N, 3), pcB (B, N, 3), labels_AB (B, N), float32."""
    B, total, _ = batch_data.shape
    n2 = total // 3            # = 2N
    N = n2 // 2
    H = N // 2
    Q = H // 2                 # N/4

    surface, near, far = np.split(batch_data, 3, axis=1)
    S_A, S_B = np.split(surface, 2, axis=1)
    near_d, far_d = np.split(batch_labels, 2, axis=1)

    pcA = S_A[:, :N]
    pcB = np.concatenate([S_B[:, :H], near[:, :Q], far[:, Q:H]], axis=1)
    labels_AB = np.concatenate(
        [np.zeros((B, H), np.float32), near_d[:, :Q], far_d[:, Q:H]], axis=1
    )
    return pcA.astype(np.float32), pcB.astype(np.float32), labels_AB.astype(np.float32)
