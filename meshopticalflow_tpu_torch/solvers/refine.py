"""Iterative refinement for the level flow solves.

Port of ``ell_solve_refined`` (meshopticalflow_tpu/solvers/refine.py:319),
with the round and stop rules of its float64 host path:

    x = 0 (float64)
    repeat: r = b - A x (float64) ; stop at rel < max(tol, 1e-11) or when
            rel > 0.5 * previous rel ; e = PCG(A, r / max|r|) in the working
            dtype ; x += e * max|r|

The residuals run in float64 on the device through the float64 SpMV kernel,
so each round crosses to the host only for its two convergence scalars.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from meshopticalflow_tpu_torch.ops.ell import ell_matvec
from meshopticalflow_tpu_torch.solvers.cg import CGStats, ell_pcg


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
) -> Tuple[torch.Tensor, CGStats]:
    """Solve A x = b to float64 residual accuracy. Returns (x in b's dtype,
    stats with the total inner iterations and the best float64 relative
    residual)."""
    vals64 = vals.to(torch.float64)
    b64 = b.to(torch.float64)

    def residual(x):
        return b64 - ell_matvec(cols, vals64, x)

    b_norm = float(torch.linalg.vector_norm(b64))
    if b_norm == 0:
        return torch.zeros_like(b), CGStats(0, 0.0)
    x = torch.zeros_like(b64)
    if x0 is not None:
        x_cand = x0.to(torch.float64)
        if (x_cand.shape == b64.shape
                and float(torch.linalg.vector_norm(residual(x_cand))) < b_norm):
            x = x_cand
    total_iters = 0
    best_x, best_rel = x, 1.0
    prev_rel = math.inf
    for _ in range(max_rounds):
        r = residual(x)
        rel = float(torch.linalg.vector_norm(r)) / b_norm
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
        scale = float(torch.max(torch.abs(r))) or 1.0
        e, stats = ell_pcg(cols, vals, diag, (r / scale).to(b.dtype),
                           tol=inner_tol, max_iters=inner_iters, chunk=chunk)
        total_iters += stats.iterations
        x = x + e.to(torch.float64) * scale
    else:
        rel = float(torch.linalg.vector_norm(residual(x))) / b_norm
        if rel < best_rel:
            best_x, best_rel = x, rel
    return best_x.to(b.dtype), CGStats(total_iters, best_rel)
