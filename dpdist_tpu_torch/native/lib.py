"""ctypes bindings and on-demand build of the native host library (port of
dpdist_tpu/native/lib.py).

src/pointcloud_native.cpp is the port's copy of the reference's source. It
builds with the reference's g++ flags into dpdist_tpu_torch/_build/
(listed in .gitignore), never into the JAX package's tree, under a
directory keyed by a hash of the source, the flags and the CPU target
that -march=native resolves to on this host: a library built for one
host's CPU is never loaded on another's. The build runs at first use (a
few seconds) into a temporary directory and is renamed into place.

As in the reference, every entry point returns None (or falls back to
numpy) when the library cannot be built or loaded, so the host paths
never depend on it; `build()` raises instead, for callers that must know.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
SRC = _HERE / "src" / "pointcloud_native.cpp"
BUILD_DIR = _HERE.parent / "_build"
LIB_NAME = "pointcloud_native.so"
# The reference's flags (dpdist_tpu/native/lib.py:31-37). No -ffast-math:
# linking crtfastmath.o from a shared library sets the process-wide
# FTZ/DAZ bits and silently changes numpy's subnormal behaviour.
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")
GXX_TIMEOUT_S = 120

_lock = threading.Lock()
_lib = None
_tried = False


def _native_target(gxx: str) -> str:
    """The -march/-mtune options g++ expands -march=native to here."""
    out = subprocess.run([gxx, "-march=native", "-E", "-v", "-x", "c++", os.devnull,
                          "-o", os.devnull], capture_output=True, text=True,
                         timeout=GXX_TIMEOUT_S).stderr
    return " ".join(line for line in out.splitlines() if "cc1plus" in line and "-march=" in line)


def library_path() -> Path:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the native host library cannot be built")
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    h.update(_native_target(gxx).encode())
    return BUILD_DIR / ("native-" + h.hexdigest()[:16]) / LIB_NAME


def build() -> Path:
    """Compile the library if this host has no build of it; return its path.
    Raises if g++ is missing or fails."""
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=out.parent)
    try:
        so = os.path.join(tmp, LIB_NAME)
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", so], capture_output=True,
                              text=True, timeout=GXX_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed (exit {proc.returncode}): {proc.stderr}")
        os.replace(so, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _declare(lib):
    fp, cl, ci = ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int
    lib.pn_parse_csv_floats.restype = cl
    lib.pn_parse_csv_floats.argtypes = [ctypes.c_char_p, fp, cl]
    lib.pn_min_distances.restype = None
    lib.pn_min_distances.argtypes = [fp, cl, fp, cl, fp, ci]
    lib.pn_nn_distance.restype = None
    lib.pn_nn_distance.argtypes = [fp, cl, fp, cl, fp, ctypes.POINTER(ci), ci]
    return lib


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            _lib = _declare(ctypes.CDLL(str(build())))
        except (OSError, RuntimeError, subprocess.SubprocessError):
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def fast_loadtxt(path: str, cols: int) -> np.ndarray:
    """Parse a delimited float text file into (rows, cols) float32; numpy's
    loadtxt if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return np.loadtxt(path, delimiter=",").astype(np.float32).reshape(-1, cols)
    max_vals = os.path.getsize(path) // 2 + 16   # a float takes >= 2 bytes of text
    buf = np.empty(max_vals, np.float32)
    n = lib.pn_parse_csv_floats(os.fsencode(path), _fp(buf), max_vals)
    if n < 0:
        raise FileNotFoundError(path)
    if n % cols:
        raise ValueError(f"{path}: parsed {n} floats, not divisible by {cols}")
    return buf[:n].reshape(-1, cols).copy()


def min_distances_native(query: np.ndarray, dense: np.ndarray, n_threads: int = 0):
    """Threaded brute-force min euclidean distances (Q,) float32, or None
    if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    q = np.ascontiguousarray(query, np.float32)
    d = np.ascontiguousarray(dense, np.float32)
    out = np.empty(len(q), np.float32)
    lib.pn_min_distances(_fp(q), len(q), _fp(d), len(d), _fp(out), n_threads)
    return out


def nn_distance_native(a: np.ndarray, b: np.ndarray, n_threads: int = 0):
    """(squared distances, indices) of the nearest b-point per a-point, or
    None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    aa = np.ascontiguousarray(a, np.float32)
    bb = np.ascontiguousarray(b, np.float32)
    dist = np.empty(len(aa), np.float32)
    idx = np.empty(len(aa), np.int32)
    lib.pn_nn_distance(_fp(aa), len(aa), _fp(bb), len(bb), _fp(dist),
                       idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n_threads)
    return dist, idx
