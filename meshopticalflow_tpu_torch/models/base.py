"""Vector-field basis: host pattern work and the device-side flow step.

Port of meshopticalflow_tpu/models/base.py. A basis is (coefficients c,
prolongation P, restriction P^T, smoothness S):
  * P is a fixed-fan-in gather  tfield[t, a] = sum_k p_wt[t, a, k] c[p_idx[t, k]]
    and P^T the matching scatter-add (VectorField.h:107-112);
  * S is static geometry, assembled on host and held as padded ELL;
  * the per-level Gauss-Newton system (R D P)/||R D P||_F + lambda S
    (VectorField.h:46-104) is built on the device by scatter-adding the
    closed-form R D P entries  val[t, k, l] = sum_ab p_wt[t,a,k] D[t,a,b] p_wt[t,b,l]
    into precomputed slots of the union pattern: one ELL matrix per level,
    solved with Jacobi-PCG inside iterative refinement.

``BasisHost`` and the pattern work of ``finalize_basis`` are copies of the
reference's host code.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from meshopticalflow_tpu_torch.config import FlowConfig, VectorFieldMode
from meshopticalflow_tpu_torch.geometry.mesh import HostMesh
from meshopticalflow_tpu_torch.ops.ell import coo_slot_map, ell_from_scipy, ell_matvec


@dataclasses.dataclass
class BasisHost:
    """Host-side basis: prolongation structure + smoothness operator."""

    name: str
    n_coeffs: int
    p_idx: np.ndarray   # (T, K) int64 coefficient indices
    p_wt: np.ndarray    # (T, 2, K) float64 weights
    smooth: sp.csr_matrix


@dataclasses.dataclass
class BasisDevice:
    """Device-side basis tensors."""

    p_idx: torch.Tensor       # (T, K) int64
    p_wt: torch.Tensor        # (T, 2, K)
    ell_cols: torch.Tensor    # (N, W) int32 — union pattern of S and R D P
    s_vals: torch.Tensor      # (N, W) smoothness values on the union pattern
    diag_slot: torch.Tensor   # (N,) int64
    dt_slots: torch.Tensor    # (T*K*K,) int64 flat slots of R D P entries
    n_coeffs: int

    @property
    def ell_width(self) -> int:
        return self.ell_cols.shape[1]


def basis_patterns(host: BasisHost):
    """Union of the S and R D P patterns and the slot maps (host numpy).

    Returns (ell_cols (N, W) int32, s_vals (N, W) float64, diag_slot (N,),
    dt_slots (T*K*K,))."""
    n = host.n_coeffs
    t_count, k = host.p_idx.shape
    rows = np.repeat(host.p_idx, k, axis=1).ravel()   # (T*K*K,) entry (t,k,l) -> p_idx[t,k]
    cols = np.tile(host.p_idx, (1, k)).ravel()        # -> p_idx[t,l]
    # Union of the S pattern and the R D P pattern. Nonzero dummy values keep
    # scipy from pruning structure; only the pattern of ``union`` is used.
    pattern = sp.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n)).tocsr()
    s_pattern = host.smooth.copy().tocsr()
    s_pattern.data = np.ones_like(s_pattern.data)
    union = (s_pattern + pattern).tocsr()
    ell = ell_from_scipy(union)
    # Overwrite values with S alone (union assembly summed S + 0-pattern).
    s_coo = host.smooth.tocoo()
    s_slots = coo_slot_map(ell.cols, s_coo.row, s_coo.col)
    vals = np.zeros(ell.cols.shape, np.float64).ravel()
    np.add.at(vals, s_slots, s_coo.data)
    vals = vals.reshape(ell.cols.shape)
    dt_slots = coo_slot_map(ell.cols, rows, cols)
    return ell.cols, vals, ell.diag_slot, dt_slots


def _dev(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)


def finalize_basis(host: BasisHost, dtype=torch.float32, device="cpu") -> BasisDevice:
    """Union the S pattern with the R D P pattern and upload the basis."""
    ell_cols, s_vals, diag_slot, dt_slots = basis_patterns(host)
    return BasisDevice(
        p_idx=_dev(host.p_idx, torch.int64, device),
        p_wt=_dev(host.p_wt, dtype, device),
        ell_cols=_dev(ell_cols, torch.int32, device),
        s_vals=_dev(s_vals, dtype, device),
        diag_slot=_dev(diag_slot, torch.int64, device),
        dt_slots=_dev(dt_slots, torch.int64, device),
        n_coeffs=host.n_coeffs,
    )


def build_basis(mesh: HostMesh, config: FlowConfig,
                device="cpu") -> Tuple[BasisHost, BasisDevice]:
    """The Whitney basis (the only family this package has)."""
    from meshopticalflow_tpu_torch.models.whitney import build_whitney_basis

    if VectorFieldMode(config.vf_mode) != VectorFieldMode.WHITNEY:
        raise NotImplementedError("only the Whitney basis is ported")
    host = build_whitney_basis(mesh)
    dtype = torch.float64 if config.dtype == "float64" else torch.float32
    return host, finalize_basis(host, dtype, device)


# ----------------------------------------------------------------------------
# Device-side operations
# ----------------------------------------------------------------------------

def prolong(basis: BasisDevice, coeffs: torch.Tensor) -> torch.Tensor:
    """tfield (T, 2) = P c  (GetTriangleVectorField, VectorField.h:107-112)."""
    return torch.einsum("tak,tk->ta", basis.p_wt, coeffs[basis.p_idx])


def restrict(basis: BasisDevice, tfield: torch.Tensor) -> torch.Tensor:
    """c (n,) = P^T y for per-triangle 2-vectors y."""
    contrib = torch.einsum("tak,ta->tk", basis.p_wt, tfield)
    out = torch.zeros(basis.n_coeffs, dtype=tfield.dtype, device=tfield.device)
    return out.index_add_(0, basis.p_idx.reshape(-1), contrib.reshape(-1))


def reduce_rhs(basis: BasisDevice, rhs_t: torch.Tensor) -> torch.Tensor:
    """R rhs, rhs given per triangle (T, 2)."""
    return restrict(basis, rhs_t)


def data_term_ell_vals(basis: BasisDevice, d_blocks: torch.Tensor) -> torch.Tensor:
    """Assembled R D P on the union ELL pattern (flattened (N*W,)).

    Duplicate COO entries fold in the scatter-add, so the Frobenius norm of
    the result equals the reference's dataTerm.SquareNorm() (VectorField.h:57)."""
    vals = torch.einsum("tak,tab,tbl->tkl", basis.p_wt, d_blocks, basis.p_wt)
    flat = torch.zeros(basis.ell_cols.numel(), dtype=vals.dtype, device=vals.device)
    return flat.index_add_(0, basis.dt_slots, vals.reshape(-1))


def build_flow_system(basis: BasisDevice, d_blocks, rhs_t, vf_smooth_weight):
    """Assemble the level system (R D P)/||.||_F + lambda S on the union ELL
    pattern plus the reduced, rescaled rhs (VectorField.h:51-67)."""
    n, w = basis.ell_cols.shape
    dt_flat = data_term_ell_vals(basis, d_blocks)
    frob = torch.sqrt(torch.sum(dt_flat * dt_flat))
    scale = torch.where(frob > 0, 1.0 / frob, torch.zeros_like(frob))
    dt_vals = (dt_flat * scale).reshape(n, w)
    sys_vals = dt_vals + vf_smooth_weight * basis.s_vals
    rhs = reduce_rhs(basis, rhs_t) * scale
    diag = torch.gather(sys_vals, 1, basis.diag_slot[:, None])[:, 0]
    return sys_vals, dt_vals, rhs, diag, scale


def finalize_flow_step(basis: BasisDevice, coeffs, x, dt_vals, rhs):
    """Optimal step tau = (x . rhs) / (x . dataTerm x) and coefficient
    update (VectorField.h:89-103)."""
    dx = ell_matvec(basis.ell_cols, dt_vals, x)
    denom = torch.dot(x, dx)
    num = torch.dot(x, rhs)
    nz = denom != 0
    step = torch.where(nz, num / torch.where(nz, denom, torch.ones_like(denom)),
                       torch.zeros_like(num))
    new_coeffs = coeffs + step * x
    return new_coeffs, prolong(basis, new_coeffs)


def update_optical_flow(
    basis: BasisDevice,
    coeffs: torch.Tensor,
    d_blocks: torch.Tensor,     # (T, 2, 2)
    rhs_t: torch.Tensor,        # (T, 2)
    vf_smooth_weight,
    cg_tol: float = 1e-7,
    cg_max_iters: int = 2000,
    cg_chunk: int = 128,
    refine: bool = True,
    x0: Optional[torch.Tensor] = None,
):
    """One Gauss-Newton flow step (VectorField::UpdateOpticalFlow,
    VectorField.h:46-104): system assembly, Jacobi-PCG (inside iterative
    refinement when ``refine``), step finalize.

    Returns (new_coeffs, tfield, solve_stats, x) where x is the solved
    direction (the next level's warm start when that is enabled)."""
    from meshopticalflow_tpu_torch.solvers.cg import ell_pcg
    from meshopticalflow_tpu_torch.solvers.refine import ell_solve_refined

    vf_smooth_weight = torch.as_tensor(vf_smooth_weight, dtype=coeffs.dtype,
                                       device=coeffs.device)
    sys_vals, dt_vals, rhs, diag, _ = build_flow_system(basis, d_blocks, rhs_t,
                                                        vf_smooth_weight)
    if refine:
        x, stats = ell_solve_refined(basis.ell_cols, sys_vals, diag, rhs,
                                     inner_tol=max(cg_tol, 1e-6),
                                     inner_iters=cg_max_iters, chunk=cg_chunk,
                                     x0=x0)
    else:
        x, stats = ell_pcg(basis.ell_cols, sys_vals, diag, rhs, x0=x0,
                           tol=cg_tol, max_iters=cg_max_iters, chunk=cg_chunk)
    new_coeffs, tfield = finalize_flow_step(basis, coeffs, x, dt_vals, rhs)
    return new_coeffs, tfield, stats, x
