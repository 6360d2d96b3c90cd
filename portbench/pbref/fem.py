"""Scalar FEM mass and stiffness matrices and the padded-ELL layout (frozen
copies of the port's ops/elements.py, ops/assemble.py and ops/ell.py host
code), and a plain ELL product."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from pbref.mesh import HAT_GRADS, HostMesh


def _assemble_vertex_operator(mesh: HostMesh, elements: np.ndarray) -> sp.csr_matrix:
    tri = mesh.triangles.astype(np.int64)
    rows = np.repeat(tri, 3, axis=1).ravel()
    cols = np.tile(tri, (1, 3)).ravel()
    mat = sp.coo_matrix((elements.ravel(), (rows, cols)),
                        shape=(mesh.n_vertices, mesh.n_vertices))
    return mat.tocsr()


def scalar_mass_csr(mesh: HostMesh) -> sp.csr_matrix:
    """Consistent mass: sqrt(det g) * (1/12 on the diagonal, 1/24 off)
    (FEM.inl:438-478)."""
    base = np.full((3, 3), 1.0 / 24.0)
    np.fill_diagonal(base, 1.0 / 12.0)
    sdet = np.sqrt(np.linalg.det(mesh.g))
    return _assemble_vertex_operator(mesh, sdet[:, None, None] * base[None])


def scalar_stiffness_csr(mesh: HostMesh) -> sp.csr_matrix:
    """sqrt(det g)/2 * <grad_i, g^-1 grad_j> (FEM.inl:479-496)."""
    g_inv = np.linalg.inv(mesh.g)
    sdet = np.sqrt(np.linalg.det(mesh.g))
    k = np.einsum("ia,tab,jb->tij", HAT_GRADS, g_inv, HAT_GRADS)
    return _assemble_vertex_operator(mesh, 0.5 * sdet[:, None, None] * k)


def ell_from_scipy(mat):
    """(cols (N, W) int64, vals (N, W), diag_slot (N,)) of a square sparse
    matrix, with an explicit diagonal slot in every row."""
    csr = sp.csr_matrix(mat)
    n = csr.shape[0]
    csr = csr + sp.identity(n, format="csr") * 0.0
    csr.sort_indices()
    row_nnz = np.diff(csr.indptr)
    w = int(row_nnz.max())
    cols = np.tile(np.arange(n, dtype=np.int64)[:, None], (1, w))
    vals = np.zeros((n, w), np.float64)
    rows = np.repeat(np.arange(n), row_nnz)
    slots = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], row_nnz)
    cols[rows, slots] = csr.indices
    vals[rows, slots] = csr.data
    diag_slot = np.argmax(cols == np.arange(n)[:, None], axis=1)
    return cols, vals, diag_slot


def coo_slot_map(ell_cols: np.ndarray, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Flat slot (row * W + k) of each COO entry inside the ELL pattern."""
    n, w = ell_cols.shape
    keys = np.arange(n, dtype=np.int64)[:, None] * n + ell_cols.astype(np.int64)
    order = np.argsort(keys.ravel(), kind="stable")
    sorted_keys = keys.ravel()[order]
    want = rows.astype(np.int64) * n + cols.astype(np.int64)
    pos = np.clip(np.searchsorted(sorted_keys, want), 0, len(sorted_keys) - 1)
    if not np.all(sorted_keys[pos] == want):
        raise ValueError("COO entries outside the ELL pattern")
    return np.arange(n * w, dtype=np.int64)[order][pos]


def ell_matvec(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A x for a padded-ELL matrix; x (N,) or (N, C)."""
    if x.dim() == 1:
        return (vals * x[cols]).sum(dim=1)
    return torch.einsum("nw,nwc->nc", vals, x[cols])
