#!/usr/bin/env python3
"""Where row 3's bf16 adjoint (csrc/table_gather.cu:table_gather_bwd_b16_kernel,
the two-byte kernel on a bf16 grad) spends its time: builds copies of the checkout's dpdist_tpu_torch, each
with one part of the kernel taken out or changed by a text substitution
(the outputs of most are wrong: only their time is read), and times each
with scripts/torch_kernel_turns.py in turns (the list, then the list
reversed), on one NVIDIA GPU. Prints one JSON line a run: the variant and
row 3 bf16's device ms at B = 256, N = 64 (strided) and N = 256.

    python3 scripts/torch_bwd_bf16_ablations.py [--out DIR]

DIR (default _smoke_tree/ablations, listed in .gitignore) holds the copies.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = "dpdist_tpu_torch/csrc/table_gather.cu"

COPY = ("""              mbar_expect_tx(&full[stage], len);
              dpdist::bulk_load(ring + static_cast<size_t>(i) * slot,
                                reinterpret_cast<const void*>(a0), len, &full[stage]);""",
        "              (void)a0; (void)len;")
SUM = ("        if (static_cast<unsigned>(dj) < static_cast<unsigned>(k) &&",
       "        if (false && static_cast<unsigned>(dj) < static_cast<unsigned>(k) &&")
# Each variant: the substitutions that make it from the kernel as it is.
VARIANTS = {
    "kernel": [],
    # No grad bytes move: the consumers sum whatever the ring holds.
    "no_copy": [COPY],
    # The consumers wait and release each stage but sum nothing.
    "no_sum": [SUM],
    "no_copy_no_sum": [COPY, SUM],
    # The producer warp alone: no copies, no consumers to wait for.
    "producer_only": [COPY,
                      ("""      if (uses >= static_cast<uint32_t>(kB16Stages))
        mbar_wait(&empty[stage], (uses / kB16Stages - 1) & 1);""", ""),
                      ("""  // The consumers: owner ctid of each item's part.""",
                       """  if (warp > 0) return;""")],
    # Every copy reads its cloud's first run: the same requests and bytes,
    # from L2.
    "from_l2": [("""            mt = make_int2(vy | (vz << 16), static_cast<int>((a & 15) / 2) - (vy * k + vz) * C);""",
                 """            mt = make_int2(vy | (vz << 16), static_cast<int>((a & 15) / 2) - (vy * k + vz) * C);
            a0 = reinterpret_cast<uintptr_t>(gb) & ~uintptr_t{15};""")],
    # Every copy twice as long: the same requests, twice the bytes.
    "twice_bytes": [("  l.slot = b16_slot(run);", "  l.slot = b16_slot(2 * run);"),
                    ("            len = static_cast<uint32_t>(((a + 2 * static_cast<uintptr_t>(run) + 15) &",
                     "            len = static_cast<uint32_t>(((a + 4 * static_cast<uintptr_t>(run) + 15) &")],
    "blocks_per_sm_2": [("constexpr int kB16BlocksPerSm = 4;", "constexpr int kB16BlocksPerSm = 2;")],
    "blocks_per_sm_6": [("constexpr int kB16BlocksPerSm = 4;", "constexpr int kB16BlocksPerSm = 6;")],
}


def make(out: Path, name: str) -> Path:
    tree = out / name
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(ROOT / "dpdist_tpu_torch", tree / "dpdist_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = tree / SRC
    text = src.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the kernel no longer holds {old[:60]!r}")
        text = text.replace(old, new)
    src.write_text(text)
    return tree


def build(tree: Path) -> None:
    subprocess.run([sys.executable, "-c", "from dpdist_tpu_torch.kernels import build; build.build()"],
                   cwd=tree, check=True, capture_output=True, timeout=900)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "_smoke_tree" / "ablations"))
    args = ap.parse_args()
    out = Path(args.out)
    trees = {name: make(out, name) for name in VARIANTS}
    with ThreadPoolExecutor(len(trees)) as pool:
        list(pool.map(build, trees.values()))
    for name in list(VARIANTS) + list(reversed(VARIANTS)):
        run = subprocess.run([sys.executable, str(ROOT / "scripts" / "torch_kernel_turns.py"),
                              "--root", str(trees[name])], check=True, capture_output=True,
                             text=True, timeout=300)
        row = json.loads(run.stdout.splitlines()[-1])
        print(json.dumps({"variant": name, "card": row["card"],
                          "n64_device_ms": row["table_gather_bwd_bf16"]["device_ms"],
                          "n256_device_ms": row["table_gather_bwd_bf16_n256"]["device_ms"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
