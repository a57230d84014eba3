"""Build and load the port's CUDA kernels: one nvcc call, a ctypes library.

All sources under dpdist_tpu_torch/csrc/ compile, in one
`nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC` call, into one shared library with a plain C interface.
The sources include no PyTorch header, so the build takes seconds rather
than the minutes of torch.utils.cpp_extension. It runs at first use, on
the machine with the card, and is cached under dpdist_tpu_torch/_build/
(listed in .gitignore) by a hash of the sources, the headers and the
flags. A missing nvcc or a failed build raises; nothing falls back to the
plain versions.

--use_fast_math is deliberately absent: it changes division and ceil at
cell edges, and so which voxel a boundary point gets.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libdpdist_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
NVCC_TIMEOUT_S = 600
MAX_SMEM = 227 * 1024       # shared memory a block can use on Hopper

_lib = None          # the loaded ctypes.CDLL, once built
build_seconds = None  # wall time of the nvcc call this process made, if any


def sources():
    return sorted(CSRC.glob("*.cu"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (looked on PATH, $CUDA_HOME/bin and "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / _digest() / LIB_NAME


def build() -> Path:
    """Compile the library if no build of these sources exists; return its path."""
    global build_seconds
    out = library_path()
    if out.is_file():
        return out
    nvcc = nvcc_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    srcs = [str(s) for s in sources()]
    # Build into a temporary name and rename, so a concurrent reader never
    # loads a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *srcs]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=NVCC_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.unlink(tmp)
        raise RuntimeError("nvcc did not finish within %d s: %s"
                           % (NVCC_TIMEOUT_S, " ".join(cmd))) from None
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError("nvcc failed (exit %d): %s\n%s\n%s" % (
            proc.returncode, " ".join(cmd), proc.stdout, proc.stderr))
    build_seconds = time.perf_counter() - t0
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process with its C
    signatures declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dpdist_mfv_gather_x.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                            cf, cf, cf, cf, cf, cf, ci, ci, vp]
        lib.dpdist_mfv_gather_x.restype = ci
        lib.dpdist_mfv_gather_x_smem.argtypes = [ci, ci, ci, ci]
        lib.dpdist_mfv_gather_x_smem.restype = ctypes.c_size_t
        lib.dpdist_threedmfv.argtypes = [vp, vp, vp, ci, ci, ci, cf, cf, cf, cf, cf, cf, ci, ci,
                                         vp]
        lib.dpdist_threedmfv.restype = ci
        lib.dpdist_threedmfv_smem.argtypes = [ci, ci]
        lib.dpdist_threedmfv_smem.restype = ctypes.c_size_t
        lib.dpdist_table_gather_smem.argtypes = [ci, ci, ci]
        lib.dpdist_table_gather_smem.restype = ctypes.c_size_t
        lib.dpdist_table_gather_x.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                                              ci, vp]
        lib.dpdist_table_gather_x.restype = ci
        lib.dpdist_table_gather.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, vp]
        lib.dpdist_table_gather.restype = ci
        i64 = ctypes.c_int64
        lib.dpdist_table_gather_bwd.argtypes = [vp, vp, i64, i64, vp, ci, ci, ci, ci, ci, ci,
                                                ci, vp]
        lib.dpdist_table_gather_bwd.restype = ci
        lib.dpdist_nn_min_points_per_block.argtypes = [ci]
        lib.dpdist_nn_min_points_per_block.restype = ci
        lib.dpdist_nn_min_sqdist.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
        lib.dpdist_nn_min_sqdist.restype = ci
        lib.dpdist_error_string.argtypes = [ci]
        lib.dpdist_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_launch(err: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError("%s kernel launch failed: CUDA error %d (%s)"
                           % (name, err, library().dpdist_error_string(err).decode()))
