"""The yardstick's arithmetic: FLOPs and bytes from shapes against the
hand-worked numbers and PERF.md's kernel bounds at their shapes."""

import json
from pathlib import Path

import numpy as np
import pytest

from portbench.core import counts

ROOT = Path(__file__).resolve().parents[2]
DPDIST = json.loads((ROOT / "portbench/configs/dpdist_3dmfv_k5.json").read_text())
AUE = json.loads((ROOT / "portbench/configs/aue_3dmfv_dpdist.json").read_text())
G, C, E, V = 512, 20, 2500, 512


def ms(work):
    return counts.bound_s(*work)[0] * 1e3


def test_decoder_row_and_calls():
    # 2 * (2,503 * 1,024 + 2 * 1,024^2 + 1,024 * 3)
    assert counts.decoder_row_flops(DPDIST) == 9_326_592
    assert counts.serve_call_flops(DPDIST, 256, 64) == 2 * 256 * 64 * 9_326_592
    assert counts.serve_call_flops(DPDIST, 256, 64) / 1e9 == pytest.approx(305.6, abs=0.05)
    assert counts.grad_call_flops(DPDIST, 256, 64) / 1e9 == pytest.approx(611.2, abs=0.05)


def test_aue_step():
    flops = counts.aue_step_flops(AUE, DPDIST, 16)
    # About 320 GFLOP a step: 94.6 forward, 189 backward,
    # 38.2 in the frozen loss.
    assert 300e9 < flops < 340e9
    loss = counts.grad_call_flops(DPDIST, 16, 64)
    assert loss / 1e9 == pytest.approx(38.2, abs=0.05)


def test_rows_at_perf_md_shapes():
    # Row 1 at 2B = 512, M = N = 64: 0.0982 ms (bytes); row 7 at B = 256,
    # N = 256: 0.0250 ms (operations).
    assert ms(counts.row1_work(512, 64, G, E)) == pytest.approx(0.0982, abs=5e-5)
    assert counts.bound_s(*counts.row1_work(512, 64, G, E))[1] == "bytes"
    assert ms(counts.row7_work(256, 256, G, C)) == pytest.approx(0.0250, abs=5e-5)
    assert counts.bound_s(*counts.row7_work(256, 256, G, C))[1] == "operations"
    # Rows 2, 3 (B = 256, N = 64) and 6 (N = 256) depend on the cells and
    # windows the queries reach; PERF.md's readings lie between the ends.
    lo2, hi2 = (ms(counts.row2_work(256, 64, V, C, E, r)) for r in (0, 256 * V))
    assert lo2 < 0.0520 < hi2
    lo3, hi3 = (ms(counts.row3_work(256, 64, V, C, w)) for w in (0, 256 * 64 * 125))
    assert lo3 < 0.0479 < hi3
    lo6, hi6 = (ms(counts.row6_work(256, 256, C, E, r)) for r in (0, 256 * V))
    assert lo6 < 0.1987 < hi6 + 1e-4


def test_windows_against_a_direct_count():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1.1, 1.1, (3, 40, 3)).astype(np.float32)
    pts[0, 0] = [-1.0, 1.0, 0.25]           # on the grid's edges
    g, k = 8, 5
    reached, inside = set(), 0
    for b in range(3):
        for p in pts[b]:
            u = (p + np.float32(1)) / np.float32(2 / g)
            idx = np.ceil(u).astype(int) - 1
            if not (np.all(u > 0) and np.all(idx <= g - 1)):
                idx = np.zeros(3, int)
            iy, ix, iz = idx[1], idx[0], idx[2]
            for a in range(-2, 3):
                for c in range(-2, 3):
                    for d in range(-2, 3):
                        n = (iy + a, ix + c, iz + d)
                        if all(0 <= x < g for x in n):
                            inside += 1
                            reached.add((b, (n[0] * g + n[1]) * g + n[2]))
    assert counts.windows(pts, g, k) == (len(reached), inside)


def test_mfu():
    assert counts.mfu_pct(67e12, 1.0) == pytest.approx(100.0)
