"""Padded-ELL sparse matvecs: hand-written CUDA kernels and their plain twins.

Two kernels (``csrc/spmv_ell.cu``) replace the reference package's Pallas
kernels (meshopticalflow_tpu/kernels/pallas_spmv.py):

    spmv_ell(cols, vals, x)        y = A x         <- _spmv_kernel
    spmv_ell_multi(cols, vals, X)  Y = A X, C <= 8 <- _spmv_multi_kernel

A is a padded-ELL operator: ``cols`` (N_out, W) int32 and ``vals``
(N_out, W), row-major; padding slots hold value 0 and a real column. x has
N_in rows, any N_in: square operators (N_in = N_out) and the rectangular
multigrid transfers P0 (fine <- coarse) and P0^T alike, as the TPU kernel
takes them with independent row and column permutations
(pallas_spmv.py:41-42). Every column index must be below N_in; that is
checked once where an operator is built (``check_columns``), not per
launch. Value types: float32 values with float32 x; bfloat16 values with
float32 x (f32 accumulation, f32 result); float64 values with float64 x.

A CUDA tensor always launches the kernel or raises. A CPU tensor goes to the
plain PyTorch version (``spmv_ell_plain`` / ``spmv_ell_multi_plain``, a
gather plus a sum over W). Each wrapper counts its kernel launches in
``<wrapper>.launches``; each plain version counts the calls it gets with CUDA
tensors in ``<plain>.cuda_calls`` (the wrappers never make such a call, so
on the main path that count stays 0). The launches are also split by form
in ``LAUNCHES_BY_FORM`` (square f32/f64, bf16, rectangular), which the smoke
run reads to show that each form of the main path reached the card.

The kernels are compiled by nvcc at first use (kernels/build.py) and loaded
with ctypes.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import numpy as np
import torch

from meshopticalflow_tpu_torch.kernels.build import CudaLibrary, raise_on, stream_of

MAX_MULTI_COLUMNS = 8

_VALUE_TYPES = {torch.float32: ("f32", torch.float32),
                torch.bfloat16: ("bf16", torch.float32),
                torch.float64: ("f64", torch.float64)}


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for tag in ("f32", "bf16", "f64"):
        fn = getattr(lib, f"spmv_ell_{tag}")
        fn.argtypes = [ptr, ptr, ptr, ptr, i64, i32, ptr]
        fn.restype = i32
        fn = getattr(lib, f"spmv_ell_multi_{tag}")
        fn.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32, ptr]
        fn.restype = i32


LIBRARY = CudaLibrary("spmv_ell", "spmv_ell.cu", _bind)
LAUNCHES_BY_FORM: Counter = Counter()


def check_columns(cols, n_in: int) -> None:
    """Host-side bound check of an operator's column indices (cols may be a
    numpy array or a tensor): every index in [0, n_in). Called once where a
    pack or operator is built; the kernels themselves do not check."""
    c = cols.detach().cpu().numpy() if isinstance(cols, torch.Tensor) else np.asarray(cols)
    if c.size and (int(c.min()) < 0 or int(c.max()) >= n_in):
        raise ValueError(f"ELL column indices span [{int(c.min())}, {int(c.max())}], "
                         f"outside the {n_in} rows of x")


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
    if x.dim() != x_ndim:
        want = "(N_in,)" if x_ndim == 1 else "(N_in, C)"
        raise ValueError(f"{name}: x must be {want}, got {tuple(x.shape)}")
    if x.shape[0] == 0 and cols.numel() > 0:
        raise ValueError(f"{name}: x has no rows for a {tuple(cols.shape)} operator")
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


def _count_form(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor) -> None:
    if cols.shape[0] != x.shape[0]:
        LAUNCHES_BY_FORM["rectangular"] += 1
    elif vals.dtype == torch.bfloat16:
        LAUNCHES_BY_FORM["bf16"] += 1
    else:
        LAUNCHES_BY_FORM["square"] += 1


def spmv_ell(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y (N_out,) = A x for a padded-ELL operator; x (N_in,)."""
    x_dtype = _check("spmv_ell", cols, vals, x, 1)
    if not x.is_cuda:
        return spmv_ell_plain(cols, vals, x)
    n, w = cols.shape
    y = torch.empty(n, dtype=x_dtype, device=x.device)
    fn = getattr(LIBRARY.load(), f"spmv_ell_{_VALUE_TYPES[vals.dtype][0]}")
    with torch.cuda.device(x.device):
        err = fn(cols.data_ptr(), vals.data_ptr(), x.data_ptr(), y.data_ptr(),
                 n, w, stream_of(x.device))
    raise_on(err, "spmv_ell")
    spmv_ell.launches += 1
    _count_form(cols, vals, x)
    return y


def spmv_ell_multi(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Y (N_out, C) = A X for a padded-ELL operator; X (N_in, C), 1 <= C <= 8."""
    x_dtype = _check("spmv_ell_multi", cols, vals, x, 2)
    c = x.shape[1]
    if not 1 <= c <= MAX_MULTI_COLUMNS:
        raise ValueError(f"spmv_ell_multi: X has {c} columns, the kernel "
                         f"takes 1..{MAX_MULTI_COLUMNS}")
    if not x.is_cuda:
        return spmv_ell_multi_plain(cols, vals, x)
    n, w = cols.shape
    y = torch.empty((n, c), dtype=x_dtype, device=x.device)
    fn = getattr(LIBRARY.load(), f"spmv_ell_multi_{_VALUE_TYPES[vals.dtype][0]}")
    with torch.cuda.device(x.device):
        err = fn(cols.data_ptr(), vals.data_ptr(), x.data_ptr(), y.data_ptr(),
                 n, w, c, stream_of(x.device))
    raise_on(err, "spmv_ell_multi")
    spmv_ell_multi.launches += 1
    _count_form(cols, vals, x)
    return y


spmv_ell.launches = 0
spmv_ell_multi.launches = 0


def reset_counts() -> None:
    """Zero the launch counts and the plain-on-CUDA call counts."""
    spmv_ell.launches = spmv_ell_multi.launches = 0
    spmv_ell_plain.cuda_calls = spmv_ell_multi_plain.cuda_calls = 0
    LAUNCHES_BY_FORM.clear()


def counts() -> dict:
    return {"spmv_ell": spmv_ell.launches,
            "spmv_ell_multi": spmv_ell_multi.launches,
            "square": LAUNCHES_BY_FORM["square"],
            "bf16": LAUNCHES_BY_FORM["bf16"],
            "rectangular": LAUNCHES_BY_FORM["rectangular"],
            "plain_on_cuda": spmv_ell_plain.cuda_calls
            + spmv_ell_multi_plain.cuda_calls}
