"""Jacobi-preconditioned conjugate gradients, matrix-free, batched multi-rhs.

Port of meshopticalflow_tpu/solvers/cg.py. All rhs columns iterate together
with per-column alpha/beta; iteration stops when every column's residual
passes the relative tolerance (or at ``max_iters``).

``pcg_multi``, ``pcg`` and ``ell_pcg`` take an optional ``rows``
(ops/rows.py: the row blocks of a ``DeviceGroup``, the counterpart of the
reference's ``axis_name``): under a split the vectors are each rank's row
block, and every column dot is summed over the ranks with
``dist.all_reduce``. Without a split nothing changes.

``ell_pcg`` is the solver of the main path. It runs ``chunk`` iterations
between host convergence checks, as the reference does, so iteration counts
come in multiples of ``chunk`` and match the reference's exactly. The
scalars of an iteration (alpha, beta) stay on the device: a chunk enqueues
its kernels without waiting for the card. Under a split ``rows`` its
operator is this rank's rows against all columns: each product gathers p
from every rank first (``DeviceGroup.all_gather_rows``), and every rank
takes the same convergence decision.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from meshopticalflow_tpu_torch.ops.ell import ell_matvec
from meshopticalflow_tpu_torch.ops.rows import Rows


class CGStats(NamedTuple):
    iterations: int
    rel_residual: float   # worst column relative residual


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den where den != 0, else 0 (the reference's guarded divide)."""
    nz = den != 0
    return torch.where(nz, num / torch.where(nz, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def _inv_diag(diag: torch.Tensor) -> torch.Tensor:
    return _safe_div(torch.ones_like(diag), diag)


def _col_dots(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("nc,nc->c", u, v)


def _row_dots(rows: Rows, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u . v, per column for (N, C) blocks, of vectors of ``rows``: summed
    over the ranks that hold them."""
    return rows.sum(_col_dots(u, v) if u.dim() == 2 else torch.dot(u, v))


def pcg_multi(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,                 # (N, C)
    diag: torch.Tensor,              # (N,)
    x0: Optional[torch.Tensor] = None,
    tol: float = 1e-7,
    max_iters: int = 1000,
    rows: Optional[Rows] = None,
):
    """Solve A x = b for SPD A with C right-hand sides simultaneously.
    Tests convergence after every iteration (one host sync each). Under a
    split ``rows`` b, diag, x0 and the result are this rank's rows, and
    ``matvec`` maps this rank's rows to this rank's rows."""
    rows = rows or Rows(b.shape[0])
    inv_diag = _inv_diag(diag)[:, None]
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x) if x0 is not None else b
    z = inv_diag * r
    p = z
    rz = _row_dots(rows, r, z)
    b_norm2 = _row_dots(rows, b, b)
    b_norm2 = torch.where(b_norm2 > 0, b_norm2, torch.ones_like(b_norm2))
    tol2 = torch.as_tensor(tol, dtype=b.dtype, device=b.device) ** 2 * b_norm2
    it = 0
    while it < max_iters and bool(torch.any(_row_dots(rows, r, r) > tol2)):
        ap = matvec(p)
        alpha = _safe_div(rz, _row_dots(rows, p, ap))
        x = x + alpha[None, :] * p
        r = r - alpha[None, :] * ap
        z = inv_diag * r
        rz_new = _row_dots(rows, r, z)
        beta = _safe_div(rz_new, rz)
        p = z + beta[None, :] * p
        rz = rz_new
        it += 1
    rel = float(torch.sqrt(torch.max(_row_dots(rows, r, r) / b_norm2)))
    return x, CGStats(it, rel)


def pcg(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,                 # (N,)
    diag: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    tol: float = 1e-7,
    max_iters: int = 1000,
    rows: Optional[Rows] = None,
):
    """Single-rhs wrapper around pcg_multi."""
    mv = lambda v: matvec(v[:, 0])[:, None]
    x0c = None if x0 is None else x0[:, None]
    x, stats = pcg_multi(mv, b[:, None], diag, x0c, tol, max_iters, rows)
    return x[:, 0], stats


def _ell_pcg_chunk(cols, vals, inv_diag, x, r, z, p, rz, iters: int, rows: Rows):
    """``iters`` PCG iterations with no host sync; returns the state and the
    squared residual norm (max over columns) as a device scalar, summed
    over the ranks that hold ``rows``."""
    multi = p.dim() == 2
    for _ in range(iters):
        ap = ell_matvec(cols, vals, rows.full(p))
        alpha = _safe_div(rz, _row_dots(rows, p, ap))
        if multi:
            x = x + alpha[None, :] * p
            r = r - alpha[None, :] * ap
            z = inv_diag[:, None] * r
        else:
            x = x + alpha * p
            r = r - alpha * ap
            z = inv_diag * r
        rz_new = _row_dots(rows, r, z)
        beta = _safe_div(rz_new, rz)
        p = z + (beta[None, :] if multi else beta) * p
        rz = rz_new
    return x, r, z, p, rz, torch.max(_row_dots(rows, r, r))


def ell_pcg(
    cols: torch.Tensor,
    vals: torch.Tensor,
    diag: torch.Tensor,
    b: torch.Tensor,                 # (N,) or (N, C)
    x0: Optional[torch.Tensor] = None,
    tol: float = 1e-7,
    max_iters: int = 1000,
    chunk: int = 128,
    b_norm2: Optional[float] = None,
    rows: Optional[Rows] = None,
):
    """Jacobi-PCG on a padded-ELL matrix with a convergence check every
    ``chunk`` iterations. ``b_norm2``: caller-known ||b||^2 (max column
    norm^2 for multi-rhs). Under a split ``rows`` (ops/rows.py) cols,
    vals, diag, b, x0 and the result are this rank's rows (cols against all
    rows), and the convergence test reads r.r summed over the ranks."""
    rows = rows or Rows(b.shape[0])
    inv_diag = _inv_diag(diag)
    multi = b.dim() == 2

    def norm2(u):
        return torch.max(_row_dots(rows, u, u))

    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - ell_matvec(cols, vals, rows.full(x))
    z = inv_diag[:, None] * r if multi else inv_diag * r
    rz = _row_dots(rows, r, z)
    b2 = b_norm2 if b_norm2 is not None else float(norm2(b))
    if b2 == 0:
        return torch.zeros_like(b), CGStats(0, 0.0)
    p = z
    threshold = (tol ** 2) * b2
    done = 0
    r2 = float(norm2(r))
    while done < max_iters and r2 > threshold:
        iters = min(chunk, max_iters - done)
        x, r, z, p, rz, r2_dev = _ell_pcg_chunk(cols, vals, inv_diag, x, r, z,
                                                p, rz, iters, rows)
        r2 = float(r2_dev)
        done += iters
    rel = math.sqrt(max(r2, 0.0) / b2)
    return x, CGStats(done, rel)
