"""Three-level multigrid PCG, all on the device.

Port of meshopticalflow_tpu/solvers/mg3.py (the reference package's "xla"
multigrid backend). Levels: the fine ELL system, the Galerkin coarse ELL
system (the pre-subdivision mesh), and the dense patch-aggregated coarsest
system, factored once per level by Cholesky (models/patches.py). No host
round trip inside the iteration: the PCG runs in fixed chunks of 8
iterations between host convergence checks, so iteration counts are
multiples of 8, as in the reference.

The fine and coarse products and all four transfers go through the SpMV
kernels (kernels/spmv.py) as padded-ELL operators in the working dtype.
The reference's alternative fine operator, an RCM-tiled block-ELL for the
TPU's matrix unit (ops/bsr.py), has no counterpart here.

Under a split ``rows`` (ops/rows.py: the fine rows cut over a
``DeviceGroup``), as GSPMD partitions the reference's cycle over a device
mesh: the fine operator is this rank's rows against all columns, the PCG
vectors and the fine Jacobi sweeps are this rank's rows, each fine product
gathers its x from every rank first, the restriction P01^T reads the
gathered fine residual, and the prolongation P01 is cut to this rank's rows
once, at construction. The coarse ELL level and the dense coarsest (its
Cholesky factor) are replicated: every rank runs them on the same gathered
input. Dot products are partial sums summed over the ranks, as the
reference's GSPMD partition takes them, which float64 refinement corrects
in the flow solve. With ``gathered_dots`` they are taken over the gathered
rows instead, and the split cycle computes one rank's numbers bit for bit:
the smoothing and DoG solves run unrefined in float32, where partial sums
put a two-rank draw at full width 1.04e-5 relative from one rank's final
alignment error (two H100s, deterministic algorithms), past the 1e-5 its
checks allow.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from meshopticalflow_tpu_torch.ops.rows import Rows
from meshopticalflow_tpu_torch.solvers.cg import CGStats
from meshopticalflow_tpu_torch.solvers.mg import EllOp, _inv_diag, _safe_div
from meshopticalflow_tpu_torch.solvers.twolevel import Transfer, _dots, _dscale
from meshopticalflow_tpu_torch.utils import spans


class ThreeLevelSolver:
    """Fine ELL + coarse ELL + dense coarsest; chunked device-only PCG, one
    rhs (N,) or a block of columns (N, C). Under a split ``rows`` of the
    fine level the fine operator, its diagonal and every vector are this
    rank's row block (see the module docstring)."""

    def __init__(self, fine_cols, fine_vals, fine_diag, c1_cols, c1_vals, c1_diag,
                 p01: Transfer, a2_dense, p12: Transfer, omega: float = 0.7,
                 nu: int = 2, rows: Optional[Rows] = None, gathered_dots: bool = False):
        dtype = fine_vals.dtype
        for t in (p01, p12):
            if t.p.vals.dtype != dtype:
                raise TypeError(f"transfer values {t.p.vals.dtype} != working dtype {dtype}")
        self.dtype = dtype
        n = p01.p.cols.shape[0]
        self.rows = rows = rows or Rows(n)
        if (rows.n, rows.n_local) != (n, fine_cols.shape[0]):
            raise ValueError(f"fine rows {fine_cols.shape[0]} of {n} do not match "
                             f"the split ({rows.n_local} of {rows.n})")
        self.gathered_dots = gathered_dots
        p01 = Transfer(EllOp(rows.local(p01.p.cols), rows.local(p01.p.vals), p01.p.n_in),
                       p01.pt)
        self.fine = EllOp(fine_cols, fine_vals.contiguous(), n)
        self.f_inv = _inv_diag(fine_diag)
        c1_vals = c1_vals.to(dtype).contiguous()
        self.c1 = EllOp(c1_cols, c1_vals, c1_cols.shape[0])
        self.c_inv = _inv_diag(c1_diag.to(dtype))
        self.p01, self.p12 = p01, p12
        with spans.timed("mg3.factor", sync=a2_dense.device) as factor:
            a2 = a2_dense.to(dtype)
            n2 = a2.shape[0]
            # Tiny Tikhonov guard keeps semi-definite coarsest systems factorable.
            eps = 1e-7 * torch.max(torch.abs(torch.diagonal(a2)))
            self.chol2 = torch.linalg.cholesky(
                a2 + eps * torch.eye(n2, dtype=dtype, device=a2.device))
        self.factor_seconds = factor.seconds
        self.omega = omega
        self.nu = nu

    @property
    def gb_per_iter(self) -> float:
        """Streamed GB per PCG iteration: the fine operator 2*nu + 1 times,
        the coarse operator 2*nu times, the four transfers once, and the
        dense coarsest factor twice (the two triangular solves)."""
        chol = self.chol2.numel() * self.chol2.element_size() / 1e9
        return ((2 * self.nu + 1) * self.fine.gigabytes + 2 * self.nu * self.c1.gigabytes
                + self.p01.gigabytes + self.p12.gigabytes + 2 * chol)

    def _fine(self, v):
        return self.fine.apply(self.rows.full(v))

    def _dots(self, u, v):
        """Column dots over every row, of vectors of this rank's rows:
        partial dots summed over the ranks, or with ``gathered_dots`` taken
        over the gathered rows (see the module docstring)."""
        if self.gathered_dots:
            return _dots(self.rows.full(u), self.rows.full(v))
        return self.rows.sum(_dots(u, v))

    def _jacobi(self, apply, inv_diag, r, z, sweeps: int):
        for _ in range(sweeps):
            z = z + self.omega * _dscale(inv_diag, r - apply(z))
        return z

    def coarse(self, r1):
        """The replicated coarse half of the cycle on the restricted
        residual: coarse Jacobi, the dense coarsest solve, coarse Jacobi."""
        om, nu = self.omega, self.nu
        z1 = self._jacobi(self.c1.apply, self.c_inv, r1, om * _dscale(self.c_inv, r1), nu - 1)
        r2 = self.p12.pt.apply(r1 - self.c1.apply(z1))
        e2 = torch.cholesky_solve(r2 if r2.dim() == 2 else r2[:, None], self.chol2)
        z1 = z1 + self.p12.p.apply(e2 if r2.dim() == 2 else e2[:, 0])
        return self._jacobi(self.c1.apply, self.c_inv, r1, z1, nu)

    def cycle(self, r):
        """The symmetric V-cycle (the reference's mg3._cycle)."""
        om, nu = self.omega, self.nu
        z = self._jacobi(self._fine, self.f_inv, r, om * _dscale(self.f_inv, r), nu - 1)
        r1 = self.p01.pt.apply(self.rows.full(r - self._fine(z)))
        z = z + self.p01.p.apply(self.coarse(r1))
        return self._jacobi(self._fine, self.f_inv, r, z, nu)

    def chunk(self, x, r, p, rz_old, iters: int):
        """``iters`` PCG iterations with no host sync; returns the state and
        the squared residual norm (max over columns) on the device."""
        for _ in range(iters):
            z = self.cycle(r)
            rz = self._dots(r, z)
            p = z + _safe_div(rz, rz_old) * p
            ap = self._fine(p)
            alpha = _safe_div(rz, self._dots(p, ap))
            x = x + alpha * p
            r = r - alpha * ap
            rz_old = rz
        return x, r, p, rz_old, torch.max(self._dots(r, r))

    def solve(self, b, x0: Optional[torch.Tensor] = None, tol: float = 1e-7,
              max_iters: int = 200, chunk: int = 8, b_norm2: Optional[float] = None):
        b_w = b.to(self.dtype)
        if b_norm2 is None:
            b_norm2 = float(torch.max(self._dots(b_w, b_w)))
        if b_norm2 == 0:
            return torch.zeros_like(b), CGStats(0, 0.0)
        x = torch.zeros_like(b_w) if x0 is None else x0.to(self.dtype)
        r = b_w if x0 is None else b_w - self._fine(x)
        p = torch.zeros_like(b_w)
        rz = torch.zeros(b_w.shape[1:], dtype=self.dtype, device=b_w.device)
        threshold = (tol ** 2) * b_norm2
        done, r2 = 0, b_norm2
        while done < max_iters and r2 > threshold:
            iters = min(chunk, max_iters - done)
            x, r, p, rz, r2_dev = self.chunk(x, r, p, rz, iters)
            r2 = float(r2_dev)
            done += iters
        rel = float(np.sqrt(max(r2, 0.0) / b_norm2))
        return x.to(b.dtype), CGStats(done, rel)
