"""Padded-ELL sparse matrices — the device sparse format of this package.

Every sparse operator lives as a padded-ELL pair

    cols: (N, W) int32   vals: (N, W) dtype

with rows padded to the max row width using the row's own index and a zero
value (gathers stay in bounds; the SpMV is one gather and a fixed-width sum).
Operators sharing a sparsity pattern (scalar mass and stiffness) share
``cols``, so per-level systems like ``M + w*K`` are one linear combination
of values away.

The host half (``HostEll``, ``ell_from_scipy``, ``coo_slot_map``) is a copy
of meshopticalflow_tpu/ops/ell.py. ``ell_matvec`` runs through the CUDA
SpMV kernels of kernels/spmv.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from meshopticalflow_tpu_torch.kernels.spmv import (MAX_MULTI_COLUMNS, spmv_ell,
                                                    spmv_ell_multi)


@dataclasses.dataclass
class HostEll:
    cols: np.ndarray        # (N, W) int32
    vals: np.ndarray        # (N, W) float64
    diag_slot: np.ndarray   # (N,) int32: slot of the diagonal entry per row

    @property
    def shape(self):
        n, _ = self.cols.shape
        return (n, n)

    def diagonal(self) -> np.ndarray:
        return np.take_along_axis(self.vals, self.diag_slot[:, None], axis=1)[:, 0]


def ell_from_scipy(mat, width: int | None = None, ensure_diag: bool = True) -> HostEll:
    """Convert a square scipy sparse matrix to padded ELL.

    ``ensure_diag`` guarantees a diagonal slot in every row (needed both for
    Jacobi preconditioning and as the padding column target).
    """
    csr = sp.csr_matrix(mat)
    n = csr.shape[0]
    if ensure_diag:
        # Add an explicit (possibly zero) diagonal to the pattern.
        pattern = csr + sp.identity(n, format="csr") * 0.0
        pattern.sort_indices()
        csr = pattern
    row_nnz = np.diff(csr.indptr)
    w = int(row_nnz.max()) if width is None else width
    if w < row_nnz.max():
        raise ValueError("requested ELL width too small")
    cols = np.tile(np.arange(n, dtype=np.int64)[:, None], (1, w))
    vals = np.zeros((n, w), np.float64)
    rows = np.repeat(np.arange(n), row_nnz)
    slots = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], row_nnz)
    cols[rows, slots] = csr.indices
    vals[rows, slots] = csr.data
    diag_mask = cols == np.arange(n)[:, None]
    # The first diagonal slot per row (padding slots also hit the diagonal
    # column but carry zero; any of them works — pick the real entry).
    diag_slot = np.argmax(diag_mask, axis=1).astype(np.int32)
    return HostEll(cols.astype(np.int32), vals, diag_slot)


def coo_slot_map(ell_cols: np.ndarray, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Flat slot index (row * W + k) of each COO entry inside the ELL pattern.

    Raises if any COO entry falls outside the pattern.
    """
    n, w = ell_cols.shape
    keys = np.arange(n, dtype=np.int64)[:, None] * n + ell_cols.astype(np.int64)
    flat = np.arange(n * w, dtype=np.int64)
    order = np.argsort(keys.ravel(), kind="stable")
    sorted_keys = keys.ravel()[order]
    want = rows.astype(np.int64) * n + cols.astype(np.int64)
    pos = np.searchsorted(sorted_keys, want)
    pos = np.clip(pos, 0, len(sorted_keys) - 1)
    if not np.all(sorted_keys[pos] == want):
        bad = np.nonzero(sorted_keys[pos] != want)[0][:5]
        raise ValueError(f"COO entries outside ELL pattern, e.g. rows {rows[bad]}, cols {cols[bad]}")
    return flat[order][pos].astype(np.int32)


def ell_matvec(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A x for a padded-ELL matrix. x may be (N,) or (N, C) multi-rhs;
    more than 8 columns run as column blocks of at most 8."""
    if x.dim() == 1:
        return spmv_ell(cols, vals, x.contiguous())
    if x.shape[1] <= MAX_MULTI_COLUMNS:
        return spmv_ell_multi(cols, vals, x.contiguous())
    return torch.cat([spmv_ell_multi(cols, vals, blk.contiguous())
                      for blk in torch.split(x, MAX_MULTI_COLUMNS, dim=1)], dim=1)
