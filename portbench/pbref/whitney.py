"""The Whitney vector-field basis and the per-level Gauss-Newton flow step
(Whitney.inl:28-180, VectorField.h:46-112, OpticalFlow.cpp:394-421): frozen
copies of the port's models/whitney.py and models/base.py host and plain
device code, and of ops/dataterm.py."""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from pbref.fem import coo_slot_map, ell_from_scipy, ell_matvec
from pbref.mesh import HAT_GRADS, HostMesh


@dataclasses.dataclass
class Basis:
    p_idx: torch.Tensor       # (T, 3) coefficient of each triangle edge
    p_wt: torch.Tensor        # (T, 2, 3) prolongation weights
    ell_cols: torch.Tensor    # (N, W) union pattern of S and R D P
    s_vals: torch.Tensor      # (N, W) smoothness operator on the pattern
    diag_slot: torch.Tensor   # (N,)
    dt_slots: torch.Tensor    # (T*9,) slots of the R D P entries
    n_coeffs: int


def edge_reduction(opp: np.ndarray):
    """Undirected edges with orientation signs (Whitney.inl:28-62)."""
    e = np.arange(len(opp))
    first = (opp < 0) | (e < opp)
    red_of_first = np.cumsum(first) - 1
    red = np.where(first, red_of_first, red_of_first[np.maximum(opp, 0)])
    sign = np.where(first, 1.0, -1.0)
    return red.astype(np.int64), sign, e[first]


def whitney_host(mesh: HostMesh):
    """(p_idx (T, 3), p_wt (T, 2, 3), smoothness S (E, E) csr) of the
    Whitney basis, S = 0.5 (d1^T m2 d1 + m1 d0 m0^-1 d0^T m1)."""
    t_count = mesh.n_triangles
    tri = mesh.triangles.astype(np.int64)
    red, sign, expanded = edge_reduction(mesh.opp)
    e_count = len(expanded)
    grad_diff = np.stack([(HAT_GRADS[(k + 2) % 3] - HAT_GRADS[(k + 1) % 3]) / 3.0
                          for k in range(3)])
    wt = np.einsum("tab,kb->tak", mesh.g_inv, grad_diff)
    wt = wt * sign.reshape(t_count, 3)[:, None, :]
    p_idx = red.reshape(t_count, 3)
    exp_t, exp_v = expanded // 3, expanded % 3
    d0_rows = np.repeat(np.arange(e_count), 2)
    d0_cols = np.stack([tri[exp_t, (exp_v + 1) % 3], tri[exp_t, (exp_v + 2) % 3]], 1).ravel()
    d0 = sp.coo_matrix((np.tile([-1.0, 1.0], e_count), (d0_rows, d0_cols)),
                       shape=(e_count, mesh.n_vertices)).tocsr()
    d1 = sp.coo_matrix((sign, (np.repeat(np.arange(t_count), 3), red)),
                       shape=(t_count, e_count)).tocsr()
    m0 = np.zeros(mesh.n_vertices)
    np.add.at(m0, tri.ravel(), np.repeat(mesh.area / 3.0, 3))
    all_t = np.arange(3 * t_count) // 3
    all_v = np.arange(3 * t_count) % 3
    half = -mesh.area[all_t] * np.einsum(
        "ea,eab,eb->e", HAT_GRADS[(all_v + 1) % 3], mesh.g_inv[all_t],
        HAT_GRADS[(all_v + 2) % 3])
    m1 = np.zeros(e_count)
    np.add.at(m1, red, half)
    rot = d1.T @ sp.diags(1.0 / mesh.area) @ d1
    div = sp.diags(m1) @ d0 @ sp.diags(1.0 / m0) @ d0.T @ sp.diags(m1)
    return p_idx, wt, ((rot + div) * 0.5).tocsr()


def build_basis(mesh: HostMesh, dtype, device) -> Basis:
    p_idx, p_wt, smooth = whitney_host(mesh)
    n = smooth.shape[0]
    k = p_idx.shape[1]
    rows = np.repeat(p_idx, k, axis=1).ravel()
    cols = np.tile(p_idx, (1, k)).ravel()
    pattern = sp.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n)).tocsr()
    s_pattern = smooth.copy()
    s_pattern.data = np.ones_like(s_pattern.data)
    ell_cols, _, diag_slot = ell_from_scipy((s_pattern + pattern).tocsr())
    s_coo = smooth.tocoo()
    vals = np.zeros(ell_cols.size, np.float64)
    np.add.at(vals, coo_slot_map(ell_cols, s_coo.row, s_coo.col), s_coo.data)

    def dev(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    return Basis(p_idx=dev(p_idx, torch.int64), p_wt=dev(p_wt, dtype),
                 ell_cols=dev(ell_cols, torch.int64),
                 s_vals=dev(vals.reshape(ell_cols.shape), dtype),
                 diag_slot=dev(diag_slot, torch.int64),
                 dt_slots=dev(coo_slot_map(ell_cols, rows, cols), torch.int64), n_coeffs=n)


def prolong(basis: Basis, coeffs: torch.Tensor) -> torch.Tensor:
    """tfield (T, 2) = P c (VectorField.h:107-112)."""
    return torch.einsum("tak,tk->ta", basis.p_wt, coeffs[basis.p_idx])


def restrict(basis: Basis, tfield: torch.Tensor) -> torch.Tensor:
    contrib = torch.einsum("tak,ta->tk", basis.p_wt, tfield)
    out = torch.zeros(basis.n_coeffs, dtype=tfield.dtype, device=tfield.device)
    return out.index_add_(0, basis.p_idx.reshape(-1), contrib.reshape(-1))


def data_term_blocks(triangles, area, values0, values1):
    """Per-triangle D (T, 2, 2) and rhs (T, 2) of SetDataTerm
    (OpticalFlow.cpp:394-421, with the intended k<2 loop)."""
    v0 = values0[triangles]
    v1 = values1[triangles]
    f = (v0 + v1) * 0.5
    mean_diff = torch.mean(v0 - v1, dim=1)
    gamma = torch.stack([f[:, 1] - f[:, 0], f[:, 2] - f[:, 0]], dim=1)
    d = torch.einsum("tkc,tlc->tkl", gamma, gamma) * area[:, None, None]
    rhs = torch.einsum("tkc,tc->tk", gamma, mean_diff) * area[:, None]
    return d, rhs


def flow_system(basis: Basis, d_blocks, rhs_t, vf_smooth_weight):
    """(R D P)/||R D P||_F + lambda S on the union pattern, its data-term
    part, the rescaled rhs and the diagonal (VectorField.h:51-67)."""
    n, w = basis.ell_cols.shape
    vals = torch.einsum("tak,tab,tbl->tkl", basis.p_wt, d_blocks, basis.p_wt)
    dt_flat = torch.zeros(n * w, dtype=vals.dtype, device=vals.device)
    dt_flat.index_add_(0, basis.dt_slots, vals.reshape(-1))
    frob = torch.sqrt(torch.sum(dt_flat * dt_flat))
    scale = torch.where(frob > 0, 1.0 / frob, torch.zeros_like(frob))
    dt_vals = (dt_flat * scale).reshape(n, w)
    rhs = restrict(basis, rhs_t) * scale
    sys_vals = dt_vals + vf_smooth_weight * basis.s_vals
    diag = torch.gather(sys_vals, 1, basis.diag_slot[:, None])[:, 0]
    return sys_vals, dt_vals, rhs, diag


def flow_step(basis: Basis, coeffs, x, dt_vals, rhs):
    """Optimal step tau = (x . rhs) / (x . D x) and the coefficient update
    (VectorField.h:89-103). Returns (coeffs, tfield)."""
    denom = torch.dot(x, ell_matvec(basis.ell_cols, dt_vals, x))
    num = torch.dot(x, rhs)
    step = torch.where(denom != 0, num / torch.where(denom != 0, denom, torch.ones_like(denom)),
                       torch.zeros_like(num))
    new_coeffs = coeffs + step * x
    return new_coeffs, prolong(basis, new_coeffs)
