"""Two-level (geometric multigrid) preconditioned CG for the flow and
smoothing systems.

Port of meshopticalflow_tpu/solvers/twolevel.py. The preconditioner is the
symmetric two-grid cycle:
    pre-smooth   nu damped-Jacobi sweeps on the fine ELL system
    coarse solve A0^-1 on the Galerkin coarse space (models/coarse.py),
                 factored once per level on the host (scipy splu; the coarse
                 grid is the pre-subdivision mesh)
    post-smooth  nu sweeps
With fixed sweep counts and an exact coarse solve it is a fixed SPD
operator, so plain PCG applies. Each iteration is split at the coarse
solve, as in the reference: the device runs the post-smooth, the CG step
and the next pre-smooth and restriction; the host solves the coarse system
in between (one device-to-host copy of the restricted residual, one
host-to-device copy of the correction).

Every fine product and both transfers go through the SpMV kernels
(kernels/spmv.py): P0 and P0^T are padded-ELL operators in the working
dtype (``Transfer``), P0^T built on the host, so the restriction is a
gather and sums in a fixed order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from meshopticalflow_tpu_torch.solvers.cg import CGStats
from meshopticalflow_tpu_torch.solvers.mg import (EllOp, _csr_to_padded_ell, _ell_op,
                                                  _inv_diag, _safe_div)
from meshopticalflow_tpu_torch.utils import spans


@dataclasses.dataclass
class Transfer:
    """A prolongation P (fine <- coarse) and its restriction P^T, both
    padded-ELL operators on the device in one value type."""

    p: EllOp     # (n_fine, K) gathers n_coarse rows
    pt: EllOp    # (n_coarse, K^T) gathers n_fine rows

    @property
    def gigabytes(self) -> float:
        return self.p.gigabytes + self.pt.gigabytes


def build_transfer(p_csr: sp.spmatrix, dtype, device) -> Transfer:
    """The Transfer of a host (n_fine, n_coarse) matrix. Stored zeros (the
    padding slots of fixed-fan-in gathers) are dropped before transposing."""
    p = sp.csr_matrix(p_csr, dtype=np.float64)
    p.eliminate_zeros()
    n_f, n_c = p.shape
    cols, vals = _csr_to_padded_ell(p)
    t_cols, t_vals = _csr_to_padded_ell(p.T.tocsr())
    return Transfer(_ell_op(cols, vals, n_c, dtype, device),
                    _ell_op(t_cols, t_vals, n_f, dtype, device))


def padded_to_csr(idx, wt, n_coarse: int) -> sp.csr_matrix:
    """(n_fine, K) padded gather form -> (n_fine, n_coarse) CSR."""
    idx = np.asarray(idx.cpu() if isinstance(idx, torch.Tensor) else idx, np.int64)
    wt = np.asarray(wt.cpu() if isinstance(wt, torch.Tensor) else wt, np.float64)
    n, k = idx.shape
    return sp.csr_matrix((wt.ravel(), (np.repeat(np.arange(n), k), idx.ravel())),
                         shape=(n, n_coarse))


def _dots(u, v):
    return (u * v).sum(dim=0) if u.dim() == 2 else torch.dot(u, v)


def _dscale(inv_diag, r):
    """inv_diag * r for (N,) or (N, C) residuals."""
    return inv_diag[:, None] * r if r.dim() == 2 else inv_diag * r


class TwoLevelSolver:
    """Per-level solver: factor the coarse system once, then PCG with one
    rhs (N,) or a block of columns (N, C)."""

    def __init__(self, fine_cols, fine_vals, fine_diag, coarse_cols, coarse_vals,
                 transfer: Transfer, omega: float = 0.7, nu: int = 2):
        self.dtype = fine_vals.dtype
        if transfer.p.vals.dtype != self.dtype:
            raise TypeError(f"transfer values {transfer.p.vals.dtype} != working "
                            f"dtype {self.dtype}")
        n = fine_cols.shape[0]
        self.fine = EllOp(fine_cols, fine_vals.contiguous(), n)
        self.inv_diag = _inv_diag(fine_diag)
        self.transfer = transfer
        self.omega = omega
        self.nu = nu
        with spans.timed("twolevel.factor") as factor:
            n_c, w0 = coarse_cols.shape
            a0 = sp.csc_matrix((coarse_vals.detach().to("cpu", torch.float64).numpy().ravel(),
                                (np.repeat(np.arange(n_c), w0),
                                 coarse_cols.cpu().numpy().ravel())), shape=(n_c, n_c))
            # Tiny Tikhonov guard for semi-definite coarse systems (the conformal
            # constants' null space), scaled to the diagonal magnitude.
            eps = 1e-12 * float(np.abs(a0.diagonal()).max() or 1.0)
            self.coarse_lu = spla.splu(a0 + eps * sp.identity(n_c, format="csc"))
        self.factor_seconds = factor.seconds
        self.n_coarse = n_c

    @property
    def gb_per_iter(self) -> float:
        """Streamed GB per PCG iteration on the device: the fine operator
        2*nu + 1 times (nu-1 pre-sweeps, the residual, nu post-sweeps, CG's
        A p), P0 and P0^T once. The coarse solve runs on the host."""
        return (2 * self.nu + 1) * self.fine.gigabytes + self.transfer.gigabytes

    def _jacobi(self, r, z, sweeps: int):
        for _ in range(sweeps):
            z = z + self.omega * _dscale(self.inv_diag, r - self.fine.apply(z))
        return z

    def pre_cycle(self, r):
        """nu damped-Jacobi sweeps from zero and the restricted residual."""
        z = self._jacobi(r, self.omega * _dscale(self.inv_diag, r), self.nu - 1)
        return z, self.transfer.pt.apply(r - self.fine.apply(z))

    def coarse_solve(self, rc: torch.Tensor) -> torch.Tensor:
        """A0^{-1} rc on the host, in float64; returned in the working dtype
        on rc's device."""
        ec = self.coarse_lu.solve(rc.detach().to("cpu", torch.float64).numpy())
        return torch.from_numpy(ec).to(device=rc.device, dtype=self.dtype)

    def post_cycle(self, r, z, ec):
        return self._jacobi(r, z + self.transfer.p.apply(ec), self.nu)

    def iteration(self, x, r, z1, ec, p, rz_old):
        """One PCG iteration around the host coarse solve: finish the
        preconditioner, the CG step, then pre-smooth and restrict the new
        residual for the next coarse solve. Returns the new state and the
        squared residual norm (max over columns) on the device."""
        z = self.post_cycle(r, z1, ec)
        rz = _dots(r, z)
        p = z + _safe_div(rz, rz_old) * p
        ap = self.fine.apply(p)
        alpha = _safe_div(rz, _dots(p, ap))
        x = x + alpha * p
        r = r - alpha * ap
        z1_next, rc_next = self.pre_cycle(r)
        return x, r, z1_next, rc_next, p, rz, torch.max(_dots(r, r))

    def solve(self, b, x0: Optional[torch.Tensor] = None, tol: float = 1e-7,
              max_iters: int = 100, b_norm2: Optional[float] = None):
        """PCG with one host coarse solve per iteration."""
        b_w = b.to(self.dtype)
        if b_norm2 is None:
            b_norm2 = float(torch.max(_dots(b_w, b_w)))
        if b_norm2 == 0:
            return torch.zeros_like(b), CGStats(0, 0.0)
        x = torch.zeros_like(b_w) if x0 is None else x0.to(self.dtype)
        r = b_w if x0 is None else b_w - self.fine.apply(x)
        z1, rc = self.pre_cycle(r)
        p = torch.zeros_like(b_w)
        rz = torch.zeros(b_w.shape[1:], dtype=self.dtype, device=b_w.device)
        threshold = (tol ** 2) * b_norm2
        it, r2 = 0, b_norm2
        while it < max_iters and r2 > threshold:
            ec = self.coarse_solve(rc)
            x, r, z1, rc, p, rz, r2_dev = self.iteration(x, r, z1, ec, p, rz)
            r2 = float(r2_dev)
            it += 1
        rel = float(np.sqrt(max(r2, 0.0) / b_norm2))
        return x.to(b.dtype), CGStats(it, rel)
