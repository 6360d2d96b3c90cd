"""Padded-ELL sparse matvecs: hand-written CUDA kernels and their plain twins.

Two kernels (``csrc/spmv_ell.cu``) replace the reference package's Pallas
kernels (meshopticalflow_tpu/kernels/pallas_spmv.py):

    spmv_ell(cols, vals, x)        y = A x         <- _spmv_kernel
    spmv_ell_multi(cols, vals, X)  Y = A X, C <= 8 <- _spmv_multi_kernel

A is the padded-ELL pair the level assembles: ``cols`` (N, W) int32 and
``vals`` (N, W), row-major; padding slots hold value 0 and a real column.
Value types: float32 values with float32 x; bfloat16 values with float32 x
(f32 accumulation, f32 result); float64 values with float64 x.

A CUDA tensor always launches the kernel or raises. A CPU tensor goes to the
plain PyTorch version (``spmv_ell_plain`` / ``spmv_ell_multi_plain``, a
gather plus a sum over W). Each wrapper counts its kernel launches in
``<wrapper>.launches``; each plain version counts the calls it gets with CUDA
tensors in ``<plain>.cuda_calls`` (the wrappers never make such a call, so
on the main path that count stays 0).

The kernels are compiled by nvcc at first use into a shared library under
``_build/`` beside this package's sources, keyed by a hash of the sources,
and loaded with ctypes.
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

import torch

_PKG = Path(__file__).resolve().parent.parent
_SOURCES = (_PKG / "csrc" / "spmv_ell.cu",)
BUILD_DIR = _PKG / "_build"
MAX_MULTI_COLUMNS = 8

_VALUE_TYPES = {torch.float32: ("f32", torch.float32),
                torch.bfloat16: ("bf16", torch.float32),
                torch.float64: ("f64", torch.float64)}

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in _SOURCES:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libspmv_ell_{digest.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile the kernels (once per source hash) and return the library path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", tmp,
           *map(str, _SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)   # atomic: concurrent builders race harmlessly
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            for tag in ("f32", "bf16", "f64"):
                fn = getattr(lib, f"spmv_ell_{tag}")
                fn.argtypes = [ptr, ptr, ptr, ptr, i64, i32, ptr]
                fn.restype = i32
                fn = getattr(lib, f"spmv_ell_multi_{tag}")
                fn.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32, ptr]
                fn.restype = i32
            _lib = lib
    return _lib


def _check(name: str, cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
           x_ndim: int) -> torch.dtype:
    """Validate operands; returns the x / result dtype."""
    if cols.dim() != 2 or cols.dtype != torch.int32:
        raise TypeError(f"{name}: cols must be a 2-D int32 tensor, got "
                        f"{tuple(cols.shape)} {cols.dtype}")
    if vals.shape != cols.shape:
        raise ValueError(f"{name}: vals shape {tuple(vals.shape)} != cols "
                         f"shape {tuple(cols.shape)}")
    if vals.dtype not in _VALUE_TYPES:
        raise TypeError(f"{name}: vals dtype {vals.dtype} not in "
                        f"float32/bfloat16/float64")
    x_dtype = _VALUE_TYPES[vals.dtype][1]
    if x.dtype != x_dtype:
        raise TypeError(f"{name}: {vals.dtype} values take {x_dtype} x, got "
                        f"{x.dtype}")
    if x.dim() != x_ndim or x.shape[0] != cols.shape[0]:
        want = "(N,)" if x_ndim == 1 else "(N, C)"
        raise ValueError(f"{name}: x must be {want} with N = {cols.shape[0]}, "
                         f"got {tuple(x.shape)}")
    if not (cols.device == vals.device == x.device):
        raise ValueError(f"{name}: operands on different devices "
                         f"({cols.device}, {vals.device}, {x.device})")
    if cols.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {cols.device}")
    if not (cols.is_contiguous() and vals.is_contiguous() and x.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous")
    return x_dtype


def spmv_ell_plain(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch y = A x: one gather and a sum over the W slots."""
    if x.is_cuda:
        spmv_ell_plain.cuda_calls += 1
    return (vals.to(x.dtype) * x[cols]).sum(dim=1)


def spmv_ell_multi_plain(cols: torch.Tensor, vals: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Y = A X for X (N, C)."""
    if x.is_cuda:
        spmv_ell_multi_plain.cuda_calls += 1
    return (vals.to(x.dtype)[:, :, None] * x[cols]).sum(dim=1)


spmv_ell_plain.cuda_calls = 0
spmv_ell_multi_plain.cuda_calls = 0


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def spmv_ell(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A x for a padded-ELL operator; x (N,)."""
    x_dtype = _check("spmv_ell", cols, vals, x, 1)
    if not x.is_cuda:
        return spmv_ell_plain(cols, vals, x)
    n, w = cols.shape
    y = torch.empty(n, dtype=x_dtype, device=x.device)
    fn = getattr(_library(), f"spmv_ell_{_VALUE_TYPES[vals.dtype][0]}")
    with torch.cuda.device(x.device):
        err = fn(cols.data_ptr(), vals.data_ptr(), x.data_ptr(), y.data_ptr(),
                 n, w, _stream(x.device))
    _raise_on(err, "spmv_ell")
    spmv_ell.launches += 1
    return y


def spmv_ell_multi(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Y = A X for a padded-ELL operator; X (N, C) with 1 <= C <= 8."""
    x_dtype = _check("spmv_ell_multi", cols, vals, x, 2)
    c = x.shape[1]
    if not 1 <= c <= MAX_MULTI_COLUMNS:
        raise ValueError(f"spmv_ell_multi: X has {c} columns, the kernel "
                         f"takes 1..{MAX_MULTI_COLUMNS}")
    if not x.is_cuda:
        return spmv_ell_multi_plain(cols, vals, x)
    n, w = cols.shape
    y = torch.empty((n, c), dtype=x_dtype, device=x.device)
    fn = getattr(_library(), f"spmv_ell_multi_{_VALUE_TYPES[vals.dtype][0]}")
    with torch.cuda.device(x.device):
        err = fn(cols.data_ptr(), vals.data_ptr(), x.data_ptr(), y.data_ptr(),
                 n, w, c, _stream(x.device))
    _raise_on(err, "spmv_ell_multi")
    spmv_ell_multi.launches += 1
    return y


spmv_ell.launches = 0
spmv_ell_multi.launches = 0


def reset_counts() -> None:
    """Zero the launch counts and the plain-on-CUDA call counts."""
    spmv_ell.launches = spmv_ell_multi.launches = 0
    spmv_ell_plain.cuda_calls = spmv_ell_multi_plain.cuda_calls = 0


def counts() -> dict:
    return {"spmv_ell": spmv_ell.launches,
            "spmv_ell_multi": spmv_ell_multi.launches,
            "plain_on_cuda": spmv_ell_plain.cuda_calls
            + spmv_ell_multi_plain.cuda_calls}
