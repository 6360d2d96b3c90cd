"""Iterative refinement for the level flow solves.

Ports of ``refine_loop`` (meshopticalflow_tpu/solvers/refine.py:59), the
adaptive loop around the multigrid solver, and ``ell_solve_refined`` (:319),
the Jacobi-PCG form, both with the round and stop rules of the reference's
float64 host path:

    x = 0 (float64)
    repeat: r = b - A x (float64) ; stop at rel < max(tol, 1e-11) or when
            rel > 0.5 * previous rel ; e = PCG(A, r / max|r|) in the working
            dtype ; x += e * max|r|

The residuals run in float64 on the device through the float64 SpMV kernel,
so each round crosses to the host only for its two convergence scalars.

Under a split ``rows`` (ops/rows.py: a ``DeviceGroup``'s row blocks) the
operator rows, b, x0 and the result are this rank's rows: each residual is
computed on those rows against the gathered x, and every norm and the scale
are reduced over the ranks, so every rank takes each branch (the start from
x0, the stop at the target or at stagnation, the best iterate) alike.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from meshopticalflow_tpu_torch.ops.ell import ell_matvec
from meshopticalflow_tpu_torch.ops.rows import Rows
from meshopticalflow_tpu_torch.solvers.cg import CGStats, ell_pcg


def refine_loop(cols: torch.Tensor, vals: torch.Tensor, b: torch.Tensor,
                inner_solve, tol: float = 1e-12, max_rounds: int = 5,
                inner_floor: float = 1e-6, x0: Optional[torch.Tensor] = None,
                rows: Optional[Rows] = None) -> Tuple[torch.Tensor, CGStats]:
    """Iterative refinement around an arbitrary inner solver.

    ``inner_solve(r, inner_tol, r_norm2) -> (e, CGStats)`` approximately
    solves A e = r to relative tolerance ``inner_tol`` (``r_norm2`` is None:
    the inner solver computes its own norm). The per-round inner tolerance
    adapts: round k only needs to close the remaining gap (tol / rel), with
    ``inner_floor`` below and 0.5 above."""
    rows = rows or Rows(b.shape[0])
    vals64 = vals.to(torch.float64)
    b64 = b.to(torch.float64)

    def residual(x):
        return b64 - ell_matvec(cols, vals64, rows.full(x))

    def norm(v):
        return float(rows.norm(v))

    b_norm = norm(b64)
    if b_norm == 0:
        return torch.zeros_like(b), CGStats(0, 0.0)
    x = torch.zeros_like(b64)
    if x0 is not None:
        x_cand = x0.to(torch.float64)
        if (x_cand.shape == b64.shape
                and norm(residual(x_cand)) < b_norm):
            x = x_cand
    total_iters = 0
    best_x, best_rel = x, math.inf
    prev_rel = math.inf
    for _ in range(max_rounds):
        r = residual(x)
        rel = norm(r) / b_norm
        if rel < best_rel:
            best_x, best_rel = x, rel
        # Stop at the target, near the float64 noise floor, or at stagnation
        # (<2x improvement): the next round's rhs would be numerical noise
        # outside range(A).
        if rel < max(tol, 1e-11) or rel > 0.5 * prev_rel:
            break
        prev_rel = rel
        # Scale the residual toward O(1) so a low-precision inner solve keeps
        # significance even when the outer residual is ~1e-10.
        scale = float(rows.amax(r)) or 1.0
        inner_tol = min(max(tol / rel, inner_floor), 0.5)
        e, stats = inner_solve((r / scale).to(b.dtype), inner_tol, None)
        total_iters += int(stats.iterations)
        x = x + e.to(torch.float64) * scale
    else:
        rel = norm(residual(x)) / b_norm
        if rel < best_rel:
            best_x, best_rel = x, rel
    return best_x.to(b.dtype), CGStats(total_iters, min(best_rel, 1e30))


def ell_solve_refined(
    cols: torch.Tensor,
    vals: torch.Tensor,       # (N, W) system values in the working dtype
    diag: torch.Tensor,
    b: torch.Tensor,          # (N,)
    tol: float = 1e-12,
    max_rounds: int = 6,
    inner_tol: float = 1e-6,
    inner_iters: int = 2000,
    chunk: int = 128,
    x0: Optional[torch.Tensor] = None,
    rows: Optional[Rows] = None,
) -> Tuple[torch.Tensor, CGStats]:
    """Solve A x = b to float64 residual accuracy. Returns (x in b's dtype,
    stats with the total inner iterations and the best float64 relative
    residual). The refinement loop with a Jacobi-PCG inner solve at the
    fixed tolerance ``inner_tol``."""
    def inner(r, _tol, _r_norm2):
        return ell_pcg(cols, vals, diag, r, tol=inner_tol, max_iters=inner_iters,
                       chunk=chunk, rows=rows)

    return refine_loop(cols, vals, b, inner, tol=tol, max_rounds=max_rounds, x0=x0,
                       rows=rows)
