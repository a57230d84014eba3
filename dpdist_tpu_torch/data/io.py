"""Point-cloud file IO: xyz txt, PLY (ascii + binary), templates h5, pose CSV.

The port's copy of dpdist_tpu/data/io.py, so that it needs nothing of the
JAX package. h5py is imported only by the two h5 functions: a machine
without it reads and writes every other format.

Covers the original's on-disk formats in one module:
- comma-separated xyz txt — the resampled ModelNet40 format consumed by
  modelnet_dataset.py:103-146 and dataset_sample_with_gt.py:79-82;
- PLY ascii/binary-little-endian — the vendored plyfile.py capability used
  by pc_util/data_prep_util (pcrnet-registration/utils/plyfile.py);
- registration templates h5 with a 'templates' dataset + files list —
  data_txt_to_hdf5.py:20-56 and helper.loadData (helper.py:46-76);
- pose CSVs of 6-dof rows — utils/create_dataset/generate_poses_ours.py
  and helper.read_poses (helper.py:120-136).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


# ---------------------------------------------------------------- xyz txt

def read_xyz_txt(path: str) -> np.ndarray:
    """Read a comma-separated xyz (or xyz+extra-cols) txt file -> (N, C) f32.

    Prefers the native fast parser (native/lib.py) when built; otherwise
    numpy. Matches np.loadtxt(path, delimiter=',') semantics.
    """
    try:
        from dpdist_tpu_torch.native import available, fast_loadtxt

        if available():
            with open(path) as f:
                first = f.readline()
            cols = len(first.strip().split(","))
            return fast_loadtxt(path, cols)
    except Exception:
        pass
    arr = np.loadtxt(path, delimiter=",").astype(np.float32)
    if arr.ndim == 1:
        arr = arr[None]
    return arr


def write_xyz_txt(path: str, points: np.ndarray) -> None:
    """Write (N, C) points as comma-separated txt (the ModelNet resampled
    format, 6 decimals like dataset_sample_with_gt.py:132-135)."""
    np.savetxt(path, np.asarray(points), fmt="%.6f", delimiter=",")


# ---------------------------------------------------------------- PLY

_PLY_HEADER_ASCII = (
    "ply\nformat ascii 1.0\nelement vertex {n}\n"
    "property float x\nproperty float y\nproperty float z\nend_header\n"
)
_PLY_HEADER_BIN = (
    "ply\nformat binary_little_endian 1.0\nelement vertex {n}\n"
    "property float x\nproperty float y\nproperty float z\nend_header\n"
)


def write_ply(path: str, points: np.ndarray, *, binary: bool = True) -> None:
    """Write an (N, 3) cloud as a PLY vertex element (x/y/z float32).

    The capability twin of the vendored plyfile writer used by
    data_prep_util.save_ply (pcrnet-registration/utils/data_prep_util.py).
    """
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    if binary:
        with open(path, "wb") as f:
            f.write(_PLY_HEADER_BIN.format(n=len(pts)).encode("ascii"))
            f.write(pts.astype("<f4").tobytes())
    else:
        with open(path, "w") as f:
            f.write(_PLY_HEADER_ASCII.format(n=len(pts)))
            for x, y, z in pts:
                f.write(f"{x:.7g} {y:.7g} {z:.7g}\n")


def read_ply(path: str) -> np.ndarray:
    """Read the vertex x/y/z properties from an ascii or
    binary-little-endian PLY -> (N, 3) f32. Supports extra float vertex
    properties (skipped) but not list properties."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n_vertex = None
        props: list[str] = []
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: truncated PLY header")
            tok = line.split()
            if not tok:
                continue
            if tok[0] == b"format":
                fmt = tok[1].decode()
            elif tok[0] == b"element":
                in_vertex = tok[1] == b"vertex"
                if in_vertex:
                    n_vertex = int(tok[2])
            elif tok[0] == b"property" and in_vertex:
                if tok[1] == b"list":
                    raise ValueError(f"{path}: list vertex properties unsupported")
                props.append(tok[2].decode())
            elif tok[0] == b"end_header":
                break
        if n_vertex is None:
            raise ValueError(f"{path}: no vertex element")
        ncols = len(props)
        ix, iy, iz = props.index("x"), props.index("y"), props.index("z")
        if fmt == "ascii":
            rows = []
            for _ in range(n_vertex):
                rows.append([float(v) for v in f.readline().split()[:ncols]])
            arr = np.asarray(rows, np.float32)
        elif fmt == "binary_little_endian":
            arr = np.frombuffer(f.read(4 * ncols * n_vertex), "<f4")
            arr = arr.reshape(n_vertex, ncols)
        else:
            raise ValueError(f"{path}: unsupported PLY format {fmt}")
        return np.ascontiguousarray(arr[:, [ix, iy, iz]]).astype(np.float32)


# ---------------------------------------------------------------- templates h5

def write_templates_h5(path: str, templates: np.ndarray,
                       files: Optional[Sequence[str]] = None) -> None:
    """Write (T, N, 3) templates under the 'templates' key + a sibling
    files.txt (data_txt_to_hdf5.py:40-56 writes both)."""
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("templates", data=np.asarray(templates, np.float32))
    if files is not None:
        txt = os.path.join(os.path.dirname(path) or ".", "files.txt")
        with open(txt, "w") as f:
            for name in files:
                f.write(f"{name}\n")


def read_templates_h5(path: str) -> np.ndarray:
    """Read the 'templates' dataset (helper.loadData, helper.py:46-76)."""
    import h5py

    with h5py.File(path, "r") as f:
        return np.asarray(f["templates"]).astype(np.float32)


# ---------------------------------------------------------------- pose csv

def write_pose_csv(path: str, poses: np.ndarray) -> None:
    """(P, 6) poses [tx ty tz rx ry rz] -> CSV
    (generate_poses_ours.py:18-21 layout)."""
    np.savetxt(path, np.asarray(poses), fmt="%.8f", delimiter=",")


def read_pose_csv(path: str) -> np.ndarray:
    """CSV -> (P, 6) f32 (helper.read_poses, helper.py:120-136)."""
    arr = np.loadtxt(path, delimiter=",").astype(np.float32)
    if arr.ndim == 1:
        arr = arr[None]
    return arr
