"""Build and load the port's CUDA kernels: nvcc per source, a ctypes library.

Each source under dpdist_tpu_torch/csrc/ compiles in its own
`nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
-fPIC -c` process, all started together, and one `nvcc -shared` call links
the objects into one shared library with a plain C interface. The build
takes as long as its slowest source (the tensor-core decoder of
fused_forward.cu), not their sum. The sources include no PyTorch header,
so it takes seconds rather than the minutes of torch.utils.cpp_extension.
It runs at first use, on the machine with the card, and is cached under
dpdist_tpu_torch/_build/ (listed in .gitignore) by a hash of the sources,
the headers and the flags. A missing nvcc or a failed build raises;
nothing falls back to the plain versions.

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
              "-Xcompiler", "-fPIC")
NVCC_TIMEOUT_S = 600
MAX_SMEM = 227 * 1024       # shared memory a block can use on Hopper

_lib = None          # the loaded ctypes.CDLL, once built
build_seconds = None  # wall time of the build this process made, if any


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


def _run_all(cmds, deadline):
    """Run the commands at once; raise naming the first that fails or is
    still running at `deadline` (time.monotonic()), after stopping the rest."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    try:
        for cmd, proc in zip(cmds, procs):
            try:
                out, err = proc.communicate(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise RuntimeError("nvcc did not finish within %d s: %s"
                                   % (NVCC_TIMEOUT_S, " ".join(cmd))) from None
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed (exit %d): %s\n%s\n%s"
                                   % (proc.returncode, " ".join(cmd), out, err))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def build() -> Path:
    """Compile the library if no build of these sources exists; return its path."""
    global build_seconds
    out = library_path()
    if out.is_file():
        return out
    nvcc = nvcc_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    # Build into a temporary directory and rename the library into place,
    # so a concurrent reader never loads a half-written one.
    tmp = tempfile.mkdtemp(dir=out.parent)
    t0 = time.perf_counter()
    deadline = time.monotonic() + NVCC_TIMEOUT_S
    try:
        objs = [os.path.join(tmp, src.stem + ".o") for src in sources()]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                  for src, obj in zip(sources(), objs)], deadline)
        lib = os.path.join(tmp, LIB_NAME)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]], deadline)
        build_seconds = time.perf_counter() - t0
        os.replace(lib, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
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
        lib.dpdist_mfv_gather_x_max_gaussians.argtypes = []
        lib.dpdist_mfv_gather_x_max_gaussians.restype = ci
        lib.dpdist_threedmfv.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, cf, cf, cf, cf,
                                         cf, cf, ci, ci, vp]
        lib.dpdist_threedmfv.restype = ci
        lib.dpdist_threedmfv_smem.argtypes = [ci, ci]
        lib.dpdist_threedmfv_smem.restype = ctypes.c_size_t
        lib.dpdist_table_gather_smem.argtypes = [ci, ci, ci]
        lib.dpdist_table_gather_smem.restype = ctypes.c_size_t
        lib.dpdist_table_gather_x.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                                              vp]
        lib.dpdist_table_gather_x.restype = ci
        lib.dpdist_table_gather.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp]
        lib.dpdist_table_gather.restype = ci
        lib.dpdist_gather_patches_fused.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
        lib.dpdist_gather_patches_fused.restype = ci
        ip, pp = ctypes.POINTER(ci), ctypes.POINTER(vp)
        lib.dpdist_fused_forward_smem.argtypes = [ci]
        lib.dpdist_fused_forward_smem.restype = ctypes.c_size_t
        lib.dpdist_fused_forward.argtypes = [vp, vp, vp, vp, pp, pp, ip, ci, ci, vp, vp, ci,
                                             vp, vp, ci, ci, ci, ci, ci, ci, vp]
        lib.dpdist_fused_forward.restype = ci
        i64 = ctypes.c_int64
        lib.dpdist_table_gather_bwd.argtypes = [vp, vp, i64, i64, vp, ci, ci, ci, ci, ci, ci,
                                                ci, vp]
        lib.dpdist_table_gather_bwd.restype = ci
        lib.dpdist_table_gather_bwd_bf16_plan.argtypes = [ci, ci, ci, ci, ci,
                                                          ctypes.POINTER(i64)]
        lib.dpdist_table_gather_bwd_bf16_plan.restype = ci
        for fn in (lib.dpdist_nn_min_tile_points, lib.dpdist_nn_min_max_chunk):
            fn.argtypes = []
            fn.restype = ci
        lib.dpdist_nn_min_blocks_per_sm.argtypes = [ci]
        lib.dpdist_nn_min_blocks_per_sm.restype = ci
        lib.dpdist_nn_min_sqdist.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, vp]
        lib.dpdist_nn_min_sqdist.restype = ci
        lib.dpdist_fused_adam_max_leaves.argtypes = []
        lib.dpdist_fused_adam_max_leaves.restype = ci
        lib.dpdist_fused_adam.argtypes = [pp, pp, pp, pp, ctypes.POINTER(i64), ci,
                                          *[cf] * 8, ci, vp]
        lib.dpdist_fused_adam.restype = ci
        lib.dpdist_error_string.argtypes = [ci]
        lib.dpdist_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_launch(err: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError("%s kernel launch failed: CUDA error %d (%s)"
                           % (name, err, library().dpdist_error_string(err).decode()))
