"""Blocked banded Cholesky factorization and panel solves, in torch.

Port of meshopticalflow_tpu/solvers/banded.py, the exact coarse-1 solve of
the multigrid cycle. The host layout (``BandPattern``, ``build_band_pattern``)
is a jax-free copy (tests/test_torch_host.py pins its source). The device
half:

    band_revalue        ELL values -> (m, nb+bw, nb) lower band blocks
    band_cholesky       right-looking banded Cholesky over the m block steps
    build_solve_panels  reblock into S = k*nb panels with inverted diagonals
    panel_lower_solve   L y = rhs, one dense step per panel
    panel_upper_solve   L^T x = y, reverse

The reference runs the last three loops as ``lax.scan``s; here they are the
hand-written kernels of csrc/banded.cu on CUDA tensors (one launch each:
kernels/banded.py) and their plain twins, Python loops of the scan bodies'
few tensor ops, on CPU tensors. ``build_solve_panels`` stays one batched
``torch.linalg.solve_triangular`` a factorization.

and, for the spectrum's shift-invert solves, ``BandedCholeskySolver`` (the
float32 factor behind an escalating diagonal shift) and the PCG it
preconditions (``ell_pcg_banded``, ``ell_pcg_banded_multi``, ``bpcg_probe``).

They run in the dtype of the values they are given: float32 on the float32
path (the reference's only precision), float64 on the float64 path, which
the card runs natively.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from meshopticalflow_tpu_torch.kernels.banded import MAX_COLUMNS, band_factor, panel_sweep
from meshopticalflow_tpu_torch.ops.bsr import rcm_permutation
from meshopticalflow_tpu_torch.ops.ell import ell_matvec
from meshopticalflow_tpu_torch.solvers.cg import CGStats, _safe_div


# ----------------------------------------------------------------------------
# Host-side layout (static per sparsity pattern)
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class BandPattern:
    """Static banded layout for one sparsity pattern."""

    perm: np.ndarray        # (n,) RCM permutation (new -> old)
    inv_perm: np.ndarray    # (n,) old -> new
    n: int
    nb: int                 # block size
    bw: int                 # padded semiband (multiple of nb)
    m: int                  # number of block steps = ceil(n / nb)
    slots: np.ndarray       # (nnz_ell,) int64 flat slot into (m, nb+bw, nb),
    #                         or the dump slot for upper-triangle duplicates


def build_band_pattern(ell_cols: np.ndarray, nb: int = 128,
                       bw_pad: Optional[int] = None) -> BandPattern:
    """RCM-order the pattern and precompute the ELL-entry -> band-slot map.

    Every ELL entry (r, c) with inv_perm[c] <= inv_perm[r] lands in the
    lower band storage of step i = inv_perm[c] // nb at (inv_perm[r] - i*nb,
    inv_perm[c] - i*nb); strict-upper entries map to a dump slot (the
    factorization symmetrizes the diagonal block from the lower triangle).
    """
    cols = np.asarray(ell_cols)
    n, w = cols.shape
    rows = np.repeat(np.arange(n, dtype=np.int64), w)
    pattern = sp.csr_matrix((np.ones(n * w, np.float32),
                             (rows, cols.astype(np.int64).ravel())),
                            shape=(n, n))
    perm = np.asarray(rcm_permutation(pattern), np.int64)
    inv_perm = np.empty(n, np.int64)
    inv_perm[perm] = np.arange(n)
    pr = inv_perm[rows]
    pc = inv_perm[cols.astype(np.int64).ravel()]
    semiband = int(np.max(np.abs(pr - pc))) if n else 0
    bw = max(int(-(-semiband // nb)) * nb, nb)
    if bw_pad is not None:
        bw = max(bw, bw_pad)
    m = -(-n // nb)
    step = pc // nb
    lower = pr >= pc
    r_off = pr - step * nb
    c_off = pc - step * nb
    slot = step * (nb + bw) * nb + r_off * nb + c_off
    dump = m * (nb + bw) * nb  # one scratch slot past the end
    slots = np.where(lower, slot, dump)
    return BandPattern(perm=perm, inv_perm=inv_perm, n=n, nb=nb, bw=bw, m=m,
                       slots=slots.astype(np.int64))


# ----------------------------------------------------------------------------
# Device side
# ----------------------------------------------------------------------------

def band_revalue(slots: torch.Tensor, ell_vals: torch.Tensor, m: int, nb: int,
                 bw: int, n: int = -1) -> torch.Tensor:
    """Scatter padded-ELL values into the (m, nb+bw, nb) band blocks.

    Rows beyond ``n`` (block padding when n % nb != 0) get a UNIT diagonal:
    decoupled identity equations, so the zero-shift Cholesky succeeds there.
    Only zero-valued ELL padding slots share a band slot with a real entry,
    so the scatter-add is exact in any order."""
    dtype, device = ell_vals.dtype, ell_vals.device
    flat = torch.zeros(m * (nb + bw) * nb + 1, dtype=dtype, device=device)
    flat.index_add_(0, slots, ell_vals.reshape(-1))
    blocks = flat[:-1].reshape(m, nb + bw, nb)
    if n >= 0 and m * nb > n:
        rows = (torch.arange(m, device=device)[:, None] * nb
                + torch.arange(nb, device=device)[None, :]) >= n
        eye = torch.eye(nb, dtype=dtype, device=device)
        blocks[:, :nb, :] += rows[:, None, :].to(dtype) * eye[None]
    return blocks


def band_cholesky(s_blocks: torch.Tensor, shift, nb: int, bw: int):
    """Blocked banded Cholesky; returns (l_blocks (m, nb+bw, nb), ok flag as
    a device bool tensor, so the caller decides when to read it).

    ``shift`` is ADDED to the diagonal (absolute). A breakdown (a window
    that is not positive definite) surfaces as ok=False; its blocks are
    replaced by finite stand-ins (identity, zero) so the sweep finishes.
    CUDA tensors: csrc/banded.cu's band_factor; CPU tensors: its plain twin
    (kernels/banded.py)."""
    return band_factor(s_blocks, shift, nb, bw)


def build_solve_panels(l_blocks: torch.Tensor, k: int):
    """Reblock an (m, nb+bw, nb) Cholesky factor into solve panels.

    Returns (dinv (mp, S, S), pbelow (mp, bw, S)) with S = k*nb and
    mp = ceil(m/k): dinv is the INVERSE of the lower-triangular S x S
    diagonal panel, pbelow the band below it. Requires S <= bw."""
    m, nbbw, nb = l_blocks.shape
    bw = nbbw - nb
    s = k * nb
    if s > bw:
        raise ValueError(f"panel width {s} exceeds band width {bw}")
    dtype, device = l_blocks.dtype, l_blocks.device
    mp = -(-m // k)
    if mp * k > m:
        eye_blk = torch.zeros((mp * k - m, nbbw, nb), dtype=dtype, device=device)
        eye_blk[:, :nb, :] = torch.eye(nb, dtype=dtype, device=device)
        l_blocks = torch.cat([l_blocks, eye_blk], dim=0)
    lb = l_blocks.reshape(mp, k, nbbw, nb)
    panel = torch.zeros((mp, s + bw, k, nb), dtype=dtype, device=device)
    for t in range(k):
        panel[:, t * nb: t * nb + nbbw, t, :] = lb[:, t]
    panel = panel.reshape(mp, s + bw, s)
    eye = torch.eye(s, dtype=dtype, device=device).expand(mp, s, s)
    # solve_triangular returns column-major panels; the sweeps take them row-major
    dinv = torch.linalg.solve_triangular(panel[:, :s, :], eye, upper=False).contiguous()
    return dinv, panel[:, s:, :].contiguous()


def panel_lower_solve(dinv: torch.Tensor, pbelow: torch.Tensor,
                      rhs_panels: torch.Tensor) -> torch.Tensor:
    """y from L y = rhs on the panel layout; rhs_panels (mp, S, c). CUDA
    tensors: one launch of csrc/banded.cu's panel_sweep; CPU tensors: its
    plain twin."""
    return panel_sweep(dinv, pbelow, rhs_panels, upper=False)


def panel_upper_solve(dinv: torch.Tensor, pbelow: torch.Tensor,
                      y_panels: torch.Tensor) -> torch.Tensor:
    """x from L^T x = y (reverse sweep) on the panel layout."""
    return panel_sweep(dinv, pbelow, y_panels, upper=True)


def band_solve_panels(dinv: torch.Tensor, pbelow: torch.Tensor,
                      perm: torch.Tensor, inv_perm: torch.Tensor,
                      b: torch.Tensor, n: int) -> torch.Tensor:
    """x = A^{-1} b through the panelized factorization (b (n,) or (n, c));
    the sweeps run on groups of at most MAX_COLUMNS columns."""
    squeeze = b.dim() == 1
    bc = b[:, None] if squeeze else b
    c = bc.shape[1]
    mp, s, _ = dinv.shape
    bp = bc.to(dinv.dtype)[perm]
    pad = mp * s - n
    if pad:
        bp = torch.cat([bp, torch.zeros((pad, c), dtype=bp.dtype, device=bp.device)])
    # the sweeps take up to MAX_COLUMNS right-hand sides a launch
    parts = []
    for j0 in range(0, c, MAX_COLUMNS):
        part = bp[:, j0:j0 + MAX_COLUMNS].contiguous().reshape(mp, s, -1)
        y = panel_lower_solve(dinv, pbelow, part)
        parts.append(panel_upper_solve(dinv, pbelow, y).reshape(mp * s, -1))
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    out = x[:n][inv_perm].to(b.dtype)
    return out[:, 0] if squeeze else out


class BandedCholeskySolver:
    """Banded direct solver with a static pattern and per-operator revalue.

    Usage::

        pat = build_band_pattern(ell_cols)          # once per pattern
        solver = BandedCholeskySolver(pat, device)
        solver.factor(ell_vals)                     # once per operator
        x = solver.solve(b)                         # (n,) or (n, c)

    The factor is float32, as the reference's: it preconditions a PCG in the
    working dtype, which recovers what the factor's rounding lost. Solve
    panels are up to 8 blocks tall. The block factor is dropped once the
    solve panels are built."""

    def __init__(self, pattern: BandPattern, device="cpu"):
        self.pat = pattern
        self.slots = torch.as_tensor(pattern.slots, device=device)
        self.perm = torch.as_tensor(pattern.perm, device=device)
        self.inv_perm = torch.as_tensor(pattern.inv_perm, device=device)
        self.panel_k = max(1, min(8, pattern.bw // pattern.nb))
        self.shift_used = 0.0
        self.dinv = None
        self.pbelow = None

    def factor(self, ell_vals: torch.Tensor,
               rel_shifts=(0.0, 1e-6, 1e-4, 1e-2, 1.0, 4.0, 16.0)):
        """Refactorize from ELL values with an escalating diagonal shift,
        each ``rel`` times max|A| (read once, after a first failure, so an
        SPD operator factors at 0.0 without it). Raises RuntimeError when
        every shift breaks down."""
        pat = self.pat
        s_blocks = band_revalue(self.slots, ell_vals.to(torch.float32), pat.m, pat.nb,
                                pat.bw, pat.n)
        dmax = None
        for rel in rel_shifts:
            if rel != 0.0 and dmax is None:
                dmax = float(torch.max(torch.abs(ell_vals)))
            shift = rel * (dmax or 0.0)
            l_blocks, ok = band_cholesky(s_blocks, shift, pat.nb, pat.bw)
            if bool(ok):
                self.shift_used = shift
                self.dinv, self.pbelow = build_solve_panels(l_blocks, self.panel_k)
                return self
        raise RuntimeError("banded Cholesky breakdown at every shift")

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        if self.dinv is None:
            raise RuntimeError("factor() before solve()")
        return band_solve_panels(self.dinv, self.pbelow, self.perm, self.inv_perm, b,
                                 self.pat.n)


# ----------------------------------------------------------------------------
# Banded-preconditioned PCG: the shift-invert inner solver. The products run
# through the SpMV kernels (ops/ell.py:ell_matvec); alpha, beta, rz and the
# zero-denominator guards stay device tensors, so a chunk reads nothing back.
# ----------------------------------------------------------------------------

def _coldot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.sum(u * v, dim=0)


def _bpcg_step(cols, vals, solver: BandedCholeskySolver, s):
    """One banded-preconditioned PCG step on (n,) or (n, c) right-hand sides
    (per-column step lengths). The single definition behind the solver
    chunks and the contraction probe, so the probe measures exactly the
    iteration it sizes."""
    x, r, z, p, rz = s
    ap = ell_matvec(cols, vals, p)
    alpha = _safe_div(rz, _coldot(p, ap))
    x = x + alpha * p
    r = r - alpha * ap
    z = solver.solve(r).to(r.dtype)
    rz_new = _coldot(r, z)
    beta = _safe_div(rz_new, rz)
    p = z + beta * p
    return x, r, z, p, rz_new


def _bpcg_chunk(cols, vals, solver: BandedCholeskySolver, x, r, z, p, rz, iters: int):
    """``iters`` steps on (n,) or (n, c) right-hand sides (the reference's
    ``_bpcg_chunk`` and ``_bpcg_multi_chunk``); returns the state and the
    squared residual norm per column (a scalar for a single rhs), on the
    device."""
    s = (x, r, z, p, rz)
    for _ in range(iters):
        s = _bpcg_step(cols, vals, solver, s)
    return (*s, _coldot(s[1], s[1]))


def bpcg_probe(cols, vals, solver: BandedCholeskySolver, b: torch.Tensor,
               iters: int) -> torch.Tensor:
    """||r||^2 trajectory (iters + 1,) of ``iters`` banded-PCG steps on rhs
    ``b``, read once by the caller: run once per factorization to measure
    the preconditioner's contraction rate, from which the fixed-trip inner
    solves are sized."""
    z0 = solver.solve(b).to(b.dtype)
    s = (torch.zeros_like(b), b, z0, z0, torch.dot(b, z0))
    hist = [torch.dot(b, b)]
    for _ in range(iters):
        s = _bpcg_step(cols, vals, solver, s)
        hist.append(torch.dot(s[1], s[1]))
    return torch.stack(hist)


def ell_pcg_banded(cols, vals, solver: BandedCholeskySolver, b: torch.Tensor,
                   tol: float = 1e-10, max_iters: int = 400, chunk: int = 16):
    """PCG on a padded-ELL system preconditioned by a banded Cholesky factor
    of (a float32 approximation of) the same system: the amortized
    shift-invert inner solve (EigenvalueSolver.h:176-217 factors S - sigma B
    once and back-substitutes per Lanczos step). Reads ||r||^2 once per
    chunk. Returns (x, CGStats)."""
    b2 = float(torch.dot(b, b))
    if b2 == 0:
        return torch.zeros_like(b), CGStats(0, 0.0)
    z = solver.solve(b).to(b.dtype)
    x, r, p, rz = torch.zeros_like(b), b, z, torch.dot(b, z)
    threshold = (tol ** 2) * b2
    done, r2 = 0, b2
    while done < max_iters and r2 > threshold:
        iters = min(chunk, max_iters - done)
        x, r, z, p, rz, r2_dev = _bpcg_chunk(cols, vals, solver, x, r, z, p, rz, iters)
        r2 = float(r2_dev)
        done += iters
    return x, CGStats(done, math.sqrt(max(r2, 0.0) / b2))


def ell_pcg_banded_multi(cols, vals, solver: BandedCholeskySolver, b: torch.Tensor,
                         tol: float = 1e-10, max_iters: int = 400, chunk: int = 16):
    """Multi-rhs ``ell_pcg_banded`` for B (n, c): one PCG per column with a
    shared preconditioner application, stepped until every column passes
    ``tol`` (converged columns take harmless extra steps). Reads the
    per-column ||r||^2 once per chunk. Returns (X, iterations)."""
    b2 = _coldot(b, b).double().cpu().numpy()
    if not b2.any():
        return torch.zeros_like(b), 0
    z = solver.solve(b).to(b.dtype)
    x, r, p, rz = torch.zeros_like(b), b, z, _coldot(b, z)
    threshold = (tol ** 2) * np.where(b2 > 0, b2, 1.0)
    done, r2 = 0, b2
    while done < max_iters and (r2 > threshold).any():
        iters = min(chunk, max_iters - done)
        x, r, z, p, rz, r2_dev = _bpcg_chunk(cols, vals, solver, x, r, z, p, rz, iters)
        r2 = r2_dev.double().cpu().numpy()
        done += iters
    return x, done
