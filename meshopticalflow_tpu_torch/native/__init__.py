"""ctypes bindings for the native host preprocessing library.

A copy of meshopticalflow_tpu/native/__init__.py with one change: g++ builds
``meshhost.cpp`` (byte-identical to the reference package's) into
``meshopticalflow_tpu_torch/_build/libmeshhost_<hash>.so``, keyed by a hash
of the source as kernels/build.py keys the CUDA libraries, instead of
writing the library next to its source. Every entry point has a numpy
fallback in geometry/ (``get_lib`` returns None when g++ fails); ``build``
raises instead, for callers that must not fall back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "meshhost.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def lib_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libmeshhost_{digest}.so"


def build() -> Path:
    """Compile the library unless it is built; raises when g++ fails."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             str(_SRC), "-o", tmp], capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)   # atomic: concurrent builders race harmlessly
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            path = build()
        except (OSError, RuntimeError, subprocess.SubprocessError):
            return None
        try:
            lib = ctypes.CDLL(str(path))
            lib.half_edge_opposites.restype = ctypes.c_int
            lib.half_edge_opposites.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32)]
            lib.rasterize_texture_source.restype = None
            lib.rasterize_texture_source.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double)]
            _LIB = lib
        except OSError:
            _LIB = None
        return _LIB


def half_edge_opposites(triangles: np.ndarray) -> Optional[np.ndarray]:
    """Native half-edge pairing; None if the library is unavailable.

    Raises ValueError on duplicated directed half-edges (matching the numpy
    implementation's check).
    """
    lib = get_lib()
    if lib is None:
        return None
    tris = np.ascontiguousarray(triangles, np.int32)
    opp = np.empty(3 * len(tris), np.int32)
    rc = lib.half_edge_opposites(
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(tris),
        opp.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        raise ValueError("mesh has duplicated directed half-edges "
                         "(non-manifold or inconsistently oriented)")
    return opp


def rasterize(face_uvs: np.ndarray, width: int, height: int,
              pad_radius: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native rasterization + dilation; None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    uvs = np.ascontiguousarray(face_uvs, np.float64)
    tri = np.empty(width * height, np.int32)
    bary = np.empty((width * height, 2), np.float64)
    lib.rasterize_texture_source(
        uvs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(uvs),
        width, height, pad_radius,
        tri.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        bary.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return tri, bary
