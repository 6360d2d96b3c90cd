"""Multigrid PCG on the Hopper padded-ELL SpMV kernels.

Port of meshopticalflow_tpu/solvers/pallas_mg.py: the flow solve
(``MG3Solver`` <- ``PallasMG3Solver``) and the multi-rhs smoothing solve
(``MG3MultiSolver`` <- ``PallasMG3MultiSolver``) of the CLI's default
configuration. The algorithm is the reference's:

  * PCG on the fine system, preconditioned by a symmetric V-cycle:
    nu-1 damped-Jacobi pre-sweeps (omega), the residual, restriction by
    P0^T, the coarse-1 correction, prolongation by P0, nu post-sweeps;
  * the coarse-1 correction is EXACT through the banded Cholesky factor
    (solvers/banded.py, the default ``mg_coarse_exact``), or, after a
    factorization breakdown at every shift, a 3-level cycle: Jacobi on c1
    around a dense Cholesky solve on the patch level, optionally inside a
    Chebyshev polynomial of degree ``cheb_k`` with bounds from power
    iteration;
  * adaptive chunking of the PCG iterations between host convergence checks
    (``_next_chunk``), with the contraction estimates carried across levels
    on the pack (the reference's ``_RHO_BY_PACK``).

Every fine, coarse-1 and transfer product goes through the SpMV kernels
(kernels/spmv.py): the f32 fine operator for CG's A p, its bfloat16 copy in
the Jacobi sweeps and the residual, the c1 operator, and the rectangular
P0 / P0^T (bfloat16 values, as the reference's packs hold them). In float64
the same cycle runs with float64 operators throughout.

The reference keeps its state in a permuted 128x128 tile layout, a TPU
workaround; here every vector stays in the level's natural order, and the
pack holds plain padded-ELL operators (no tiles, permutations or buckets).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from meshopticalflow_tpu_torch.kernels.spmv import check_columns
from meshopticalflow_tpu_torch.ops.ell import ell_matvec
from meshopticalflow_tpu_torch.solvers.banded import (
    band_cholesky, band_revalue, build_band_pattern, build_solve_panels,
    panel_lower_solve, panel_upper_solve)
from meshopticalflow_tpu_torch.solvers.cg import CGStats
from meshopticalflow_tpu_torch.utils import spans


def _csr_to_padded_ell(mat: sp.spmatrix):
    """(cols (n, W) int32, vals (n, W) f64) padded with row-0-target zeros."""
    csr = sp.csr_matrix(mat)
    csr.sort_indices()
    n = csr.shape[0]
    nnz = np.diff(csr.indptr)
    w = max(int(nnz.max()), 1)
    cols = np.zeros((n, w), np.int64)
    vals = np.zeros((n, w), np.float64)
    rows = np.repeat(np.arange(n), nnz)
    slots = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], nnz)
    cols[rows, slots] = csr.indices
    vals[rows, slots] = csr.data
    # Padding targets the row's first real column (value 0, in-pattern).
    first = np.where(nnz > 0, cols[:, 0], 0)
    pad = np.arange(w)[None, :] >= nnz[:, None]
    cols = np.where(pad, first[:, None], cols)
    return cols.astype(np.int32), vals


def _duplicate_map(cols: np.ndarray) -> np.ndarray:
    """Flat slot of the first occurrence of each slot's (row, column) pair.

    The reference revalues its tiles by scatter-ADD, so a row that repeats a
    column holds the SUM of those values before the bf16 cast
    (pallas_spmv.py:385-392); ``bf16_values`` sums through this map the same
    way before it rounds."""
    n, w = cols.shape
    flat = np.arange(n * w, dtype=np.int64).reshape(n, w)
    order = np.argsort(cols, axis=1, kind="stable")
    sc = np.take_along_axis(cols, order, axis=1)
    first = np.ones((n, w), bool)
    first[:, 1:] = sc[:, 1:] != sc[:, :-1]
    grp = np.maximum.accumulate(np.where(first, np.arange(w)[None, :], 0), axis=1)
    canon_sorted = np.take_along_axis(flat, np.take_along_axis(order, grp, axis=1), axis=1)
    canon = np.empty_like(flat)
    np.put_along_axis(canon, order, canon_sorted, axis=1)
    return canon.ravel()


@dataclasses.dataclass
class EllOp:
    """A padded-ELL operator (n_out, W) applied through the SpMV kernels."""

    cols: torch.Tensor     # (n_out, W) int32, every index < n_in
    vals: torch.Tensor     # (n_out, W) float32, bfloat16 or float64
    n_in: int

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] != self.n_in:
            raise ValueError(f"operator takes {self.n_in} rows, x has {x.shape[0]}")
        return ell_matvec(self.cols, self.vals, x)

    @property
    def gigabytes(self) -> float:
        """Bytes one product streams for the operator (values + indices)."""
        return (self.cols.numel() * 4 + self.vals.numel() * self.vals.element_size()) / 1e9


def bf16_values(vals: torch.Tensor, canon: torch.Tensor) -> torch.Tensor:
    """bfloat16 copy of ELL values, duplicate (row, col) slots summed first."""
    summed = torch.zeros(vals.numel(), dtype=vals.dtype, device=vals.device)
    summed.index_add_(0, canon, vals.reshape(-1))
    return summed.reshape(vals.shape).to(torch.bfloat16)


def _inv_diag(diag: torch.Tensor) -> torch.Tensor:
    nz = diag != 0
    return torch.where(nz, 1.0 / torch.where(nz, diag, torch.ones_like(diag)),
                       torch.zeros_like(diag))


def _safe_div(num, den):
    nz = den != 0
    return torch.where(nz, num / torch.where(nz, den, torch.ones_like(den)),
                       torch.zeros_like(num))


@dataclasses.dataclass
class MGPack:
    """Static (per-problem) operators of the hierarchy, on the device.

    ``p0`` / ``p0t`` hold bfloat16 values when the working dtype is float32
    (the reference's static bf16 transfers) and float64 values otherwise;
    ``p12`` / ``p12t`` (the 3-level fallback's patch transfer) hold the
    working dtype. ``stats`` records the transfer layouts (widths, padding
    share) for PERF.md. ``rho`` carries each solver kind's contraction
    estimates (worst, best) from one level's solver to the next: the level
    systems of one problem differ only in the data term and the smoothing
    weight (the reference keys them by pack in ``_RHO_BY_PACK``)."""

    fine_cols: torch.Tensor
    fine_canon: torch.Tensor
    c1_cols: torch.Tensor
    c1_canon: torch.Tensor
    p0: EllOp              # fine <- c1 prolongation
    p0t: EllOp             # c1 <- fine restriction
    p12: EllOp             # c1 <- patch
    p12t: EllOp            # patch <- c1
    n_fine: int
    n1: int
    n2: int
    stats: dict
    rho: dict = dataclasses.field(default_factory=dict)


def _ell_op(cols: np.ndarray, vals: np.ndarray, n_in: int, dtype, device) -> EllOp:
    check_columns(cols, n_in)
    return EllOp(torch.as_tensor(np.ascontiguousarray(cols, np.int32)).to(device),
                 torch.as_tensor(np.ascontiguousarray(vals)).to(device=device, dtype=dtype),
                 n_in)


def build_mg_pack(fine_ell_cols, c1_ell_cols, p0_csr: sp.spmatrix,
                  p12_idx: np.ndarray, p12_wt: np.ndarray, n2: int,
                  dtype=torch.float32, device="cpu") -> MGPack:
    """The padded-ELL operators of one hierarchy (host work once per problem).

    P0^T is built on the host from P0: a coarse DoF gathers every fine DoF
    that prolongs from it, so its rows are ragged and its ELL width is far
    above P0's; a scatter-add restriction would instead make the result
    depend on atomic order."""
    fine_cols = np.asarray(fine_ell_cols.cpu() if isinstance(fine_ell_cols, torch.Tensor)
                           else fine_ell_cols)
    c1_cols = np.asarray(c1_ell_cols.cpu() if isinstance(c1_ell_cols, torch.Tensor)
                         else c1_ell_cols)
    n_f, n1 = fine_cols.shape[0], c1_cols.shape[0]
    check_columns(fine_cols, n_f)
    check_columns(c1_cols, n1)
    # Stored zeros (the zero-weight padding slots of the fixed-fan-in
    # transfers) are dropped before transposing: in P^T they all land in
    # column 0's row and would widen the whole ELL to the number of slots.
    p0_c = sp.csr_matrix(p0_csr)
    p0_c.eliminate_zeros()
    if p0_c.shape != (n_f, n1):
        raise ValueError(f"P0 shape {p0_c.shape} != ({n_f}, {n1})")
    transfer_dtype = torch.bfloat16 if dtype == torch.float32 else dtype
    p0_cols, p0_vals = _csr_to_padded_ell(p0_c)
    p0t_cols, p0t_vals = _csr_to_padded_ell(p0_c.T.tocsr())
    p12_idx = np.asarray(p12_idx, np.int64)
    p12_wt = np.asarray(p12_wt, np.float64)
    k12 = p12_idx.shape[1]
    p12_csr = sp.csr_matrix((p12_wt.ravel(), (np.repeat(np.arange(n1), k12),
                                              p12_idx.ravel())), shape=(n1, n2))
    p12_csr.eliminate_zeros()
    p12t_cols, p12t_vals = _csr_to_padded_ell(p12_csr.T.tocsr())
    stats = dict(
        fine_width=int(fine_cols.shape[1]), c1_width=int(c1_cols.shape[1]),
        p0_width=int(p0_cols.shape[1]), p0t_width=int(p0t_cols.shape[1]),
        p0t_padding_share=1.0 - p0_c.nnz / float(p0t_cols.size),
        p12t_width=int(p12t_cols.shape[1]))
    return MGPack(
        fine_cols=torch.as_tensor(fine_cols.astype(np.int32)).to(device),
        fine_canon=torch.as_tensor(_duplicate_map(fine_cols)).to(device),
        c1_cols=torch.as_tensor(c1_cols.astype(np.int32)).to(device),
        c1_canon=torch.as_tensor(_duplicate_map(c1_cols)).to(device),
        p0=_ell_op(p0_cols, p0_vals, n1, transfer_dtype, device),
        p0t=_ell_op(p0t_cols, p0t_vals, n_f, transfer_dtype, device),
        p12=_ell_op(p12_idx, p12_wt, n2, dtype, device),
        p12t=_ell_op(p12t_cols, p12t_vals, n1, dtype, device),
        n_fine=n_f, n1=n1, n2=int(n2), stats=stats)


# ----------------------------------------------------------------------------
# The exact banded coarse-1 solve
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class BandedC1:
    """Static band layout of the c1 system (solvers/banded.py) on the device."""

    slots: torch.Tensor      # ELL-entry -> band slot map
    perm: torch.Tensor       # band row -> c1 index
    inv_perm: torch.Tensor   # c1 index -> band row
    nb: int
    bw: int
    m: int
    n1: int


def build_c1_band(c1_ell_cols, nb: int = 128, device="cpu") -> BandedC1:
    """Band layout for the c1 system."""
    cols = np.asarray(c1_ell_cols.cpu() if isinstance(c1_ell_cols, torch.Tensor)
                      else c1_ell_cols)
    pat = build_band_pattern(cols, nb=nb)
    return BandedC1(slots=torch.as_tensor(pat.slots).to(device),
                    perm=torch.as_tensor(pat.perm).to(device),
                    inv_perm=torch.as_tensor(pat.inv_perm).to(device),
                    nb=pat.nb, bw=pat.bw, m=pat.m, n1=pat.n)


def _inner1_exact(dinv, pbelow, band: BandedC1, r1: torch.Tensor) -> torch.Tensor:
    """z1 = A1^{-1} r1 through the panelized banded factor; r1 (n1,) or (n1, C).
    Panels stored in bfloat16 are widened per panel to r1's dtype. A span
    ``mg.c1_solve``, timed on the device."""
    with spans.span("mg.c1_solve", device=r1.is_cuda):
        flat = r1[:, None] if r1.dim() == 1 else r1
        c = flat.shape[1]
        mp, s, _ = dinv.shape
        rhs = flat[band.perm]
        pad = mp * s - band.n1
        if pad:
            rhs = torch.cat([rhs, torch.zeros((pad, c), dtype=rhs.dtype, device=rhs.device)])
        y = panel_lower_solve(dinv, pbelow, rhs.reshape(mp, s, c))
        x = panel_upper_solve(dinv, pbelow, y)
        out = x.reshape(mp * s, c)[: band.n1][band.inv_perm]
        return out[:, 0] if r1.dim() == 1 else out


def _factor_c1_panels(c1_band: BandedC1, c1_ell_vals, c1_diag,
                      defer_check: bool = False, bf16: bool = False):
    """Factor the c1 system on its band layout and reblock into solve
    panels. Returns (dinv, pbelow, ok_dev); (None, None, None) on total
    breakdown (the caller falls back to the 3-level cycle).

    ``bf16`` stores the panels in bfloat16 (``mg_c1_bf16``, the reference's
    pallas_mg.py:383-418): they are the largest per-iteration stream of the
    exact-c1 cycle, and as a preconditioner component a coarse solve of
    ~1e-2 accuracy still serves; the sweeps compute in the residual's dtype
    from them (``_inner1_exact``).

    ``defer_check=True`` returns the shift-0 attempt at once with its ok
    flag unread on the device; the solver reads it with its first chunk's
    residual, and a failure then costs one escalating re-factorization
    (``_refactor_c1_checked``), as in the reference."""
    s_blocks = band_revalue(c1_band.slots, c1_ell_vals, c1_band.m, c1_band.nb,
                            c1_band.bw, c1_band.n1)

    def panels(l_blocks):
        k = max(1, min(8, c1_band.bw // c1_band.nb))
        dinv, pbelow = build_solve_panels(l_blocks, k)
        if bf16:
            return dinv.to(torch.bfloat16), pbelow.to(torch.bfloat16)
        return dinv, pbelow

    dmax = None
    for rel in (0.0, 1e-6, 1e-4, 1e-2):
        if rel != 0.0 and dmax is None:
            dmax = float(torch.max(torch.abs(c1_diag)))
        l_blocks, ok = band_cholesky(s_blocks, rel * (dmax or 0.0), c1_band.nb,
                                     c1_band.bw)
        if rel == 0.0 and defer_check:
            dinv, pbelow = panels(l_blocks)
            return dinv, pbelow, ok
        if bool(ok):
            dinv, pbelow = panels(l_blocks)
            return dinv, pbelow, ok
    return None, None, None


class BandedBreakdownError(RuntimeError):
    """The banded c1 factorization failed at every shift of the escalation
    ladder (raised at the first solve fetch under the deferred check).
    Callers rebuild with the 3-level Jacobi+patch fallback."""


def _refactor_c1_checked(solver) -> None:
    """Escalated re-factorization after a deferred shift-0 failure; swaps the
    shifted factor into the solver or raises BandedBreakdownError."""
    band, vals, diag, bf16 = solver._c1_factor_args
    dinv, pbelow, _ = _factor_c1_panels(band, vals, diag, bf16=bf16)
    if dinv is None:
        solver.c1_dinv = None
        solver.c1_pbelow = None
        raise BandedBreakdownError("banded c1 factorization failed at every shift")
    solver.c1_dinv, solver.c1_pbelow = dinv, pbelow


# ----------------------------------------------------------------------------
# Smoothers and cycles (vectors (n,) or (n, C); matvecs through EllOp)
# ----------------------------------------------------------------------------

def _jac(apply_, inv_diag, r, z, omega, nu: int):
    for _ in range(nu):
        z = z + omega * inv_diag * (r - apply_(z))
    return z


def _cheb_smooth(apply_, invd, r, z0, deg: int, lmin, lmax):
    """Chebyshev semi-iteration on D^-1 A over [lmin, lmax]; z0=None starts
    from zero (skipping the first matvec)."""
    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0
    res = r if z0 is None else r - apply_(z0)
    d_vec = invd * res / theta
    z = d_vec if z0 is None else z0 + d_vec
    alpha_prev = 1.0 / theta
    for _ in range(deg - 1):
        res = r - apply_(z)
        beta = (delta * alpha_prev / 2.0) ** 2
        alpha = 1.0 / (theta - beta / alpha_prev)
        d_vec = alpha * (invd * res) + (alpha * beta / alpha_prev) * d_vec
        z = z + d_vec
        alpha_prev = alpha
    return z


def _inner1(c1: EllOp, c1_invd, chol2, pack: MGPack, r1, omega, nu: int):
    """Symmetric 2-level cycle on the coarse-1 system (Jacobi + patch-exact):
    a fixed SPD operator, usable inside a Chebyshev polynomial."""
    z1 = _jac(c1.apply, c1_invd, r1, omega * c1_invd * r1, omega, nu - 1)
    res1 = r1 - c1.apply(z1)
    r2 = pack.p12t.apply(res1)
    e2 = torch.cholesky_solve(r2[:, None] if r2.dim() == 1 else r2, chol2)
    corr = pack.p12.apply(e2[:, 0] if r2.dim() == 1 else e2)
    return _jac(c1.apply, c1_invd, r1, z1 + corr, omega, nu)


def _cycle(fine_bf: EllOp, f_invd, c1: EllOp, c1_invd, chol2, pack: MGPack, r,
           omega, nu: int, cheb_k: int = 1, cheb_lmin=0.02, cheb_lmax=1.05):
    """Symmetric 3-level V-cycle; cheb_k > 1 runs the coarse-1 solve as a
    k-step Chebyshev polynomial in (inner1 o A1)."""
    z = _jac(fine_bf.apply, f_invd, r, omega * f_invd * r, omega, nu - 1)
    res = r - fine_bf.apply(z)
    r1 = pack.p0t.apply(res)
    if cheb_k <= 1:
        z1 = _inner1(c1, c1_invd, chol2, pack, r1, omega, nu)
    else:
        theta = (cheb_lmax + cheb_lmin) / 2.0
        delta = (cheb_lmax - cheb_lmin) / 2.0
        d_vec = _inner1(c1, c1_invd, chol2, pack, r1, omega, nu) / theta
        z1 = d_vec
        alpha_prev = 1.0 / theta
        for _ in range(cheb_k - 1):
            res1 = r1 - c1.apply(z1)
            beta = (delta * alpha_prev / 2.0) ** 2
            alpha = 1.0 / (theta - beta / alpha_prev)
            d_vec = (alpha * _inner1(c1, c1_invd, chol2, pack, res1, omega, nu)
                     + (alpha * beta / alpha_prev) * d_vec)
            z1 = z1 + d_vec
            alpha_prev = alpha
    z = z + pack.p0.apply(z1)
    return _jac(fine_bf.apply, f_invd, r, z, omega, nu)


def _cycle_exact(fine_bf: EllOp, f_invd, dinv, pbelow, band: BandedC1,
                 pack: MGPack, r, omega, nu: int, cheb_deg: int = 0,
                 f_lmin=None, f_lmax=None):
    """Two-level V-cycle with the EXACT banded c1 solve; ``cheb_deg`` > 0
    replaces the Jacobi sweeps with a Chebyshev smoother over [f_lmin, f_lmax]."""
    if cheb_deg > 0:
        z = _cheb_smooth(fine_bf.apply, f_invd, r, None, cheb_deg, f_lmin, f_lmax)
    else:
        z = _jac(fine_bf.apply, f_invd, r, omega * f_invd * r, omega, nu - 1)
    res = r - fine_bf.apply(z)
    r1 = pack.p0t.apply(res)
    z1 = _inner1_exact(dinv, pbelow, band, r1)
    z = z + pack.p0.apply(z1)
    if cheb_deg > 0:
        return _cheb_smooth(fine_bf.apply, f_invd, r, z, cheb_deg, f_lmin, f_lmax)
    return _jac(fine_bf.apply, f_invd, r, z, omega, nu)


def _power_seed(n: int, device, dtype) -> torch.Tensor:
    """The reference's deterministic power-iteration seed over its padded
    tile vector: sin(0.7 j + 0.3) for j < 128 * (block rows rounded up to 8).
    The entries past n stand for the padding slots, which every product
    maps to zero (``_pad_mv``)."""
    nr = -(-(-(-n // 128)) // 8) * 8
    return torch.sin(0.7 * torch.arange(nr * 128, dtype=torch.float32) + 0.3) \
        .to(device=device, dtype=dtype)


def _pad_mv(mv, n: int):
    def padded(v):
        out = torch.zeros_like(v)
        out[:n] = mv(v[:n])
        return out
    return padded


def _cheb_bounds(solver, piters: int = 20):
    """Spectral bounds of the _inner1-preconditioned coarse-1 operator by
    power iteration for lmax and a shifted power iteration for lmin, with the
    same matvecs the cycle uses; padded and clamped as in the reference."""
    pack, n1 = solver.pack, solver.pack.n1
    mv = _pad_mv(lambda v: _inner1(solver.c1_bf, solver.c1_invd, solver.chol2, pack,
                                   solver.c1_bf.apply(v), solver.omega, solver.nu), n1)
    seed = _power_seed(n1, solver.c1_invd.device, solver.c1_invd.dtype)
    v = seed / torch.sqrt(torch.dot(seed, seed))
    for _ in range(piters):
        w = mv(v)
        v = w / torch.sqrt(torch.dot(w, w))
    lmax = torch.dot(v, mv(v))
    s = 1.05 * lmax
    v = seed
    for _ in range(piters):
        w = s * v - mv(v)
        v = w / torch.sqrt(torch.dot(w, w))
    mu = torch.dot(v, s * v - mv(v))
    lmin = s - mu
    lmax = torch.where(torch.isfinite(lmax) & (lmax > 0), 1.02 * lmax,
                       torch.full_like(lmax, 1.05))
    lmin = torch.where(torch.isfinite(lmin), 0.7 * lmin, 0.01 * lmax)
    lmin = torch.minimum(torch.maximum(lmin, 1e-3 * lmax), 0.5 * lmax)
    return lmin, lmax


def _fine_lmax(solver, piters: int = 15):
    """lambda_max of D^-1 A_fine by power iteration (once per solver when
    the Chebyshev fine smoother is active)."""
    n = solver.pack.n_fine
    mv = _pad_mv(lambda v: solver.f_invd * solver.fine_bf.apply(v), n)
    v = _power_seed(n, solver.f_invd.device, solver.f_invd.dtype)
    v = v / torch.sqrt(torch.dot(v, v))
    for _ in range(piters):
        w = mv(v)
        v = w / torch.sqrt(torch.dot(w, w))
    lmax = torch.dot(v, mv(v))
    return torch.where(torch.isfinite(lmax) & (lmax > 0), 1.05 * lmax,
                       torch.full_like(lmax, 2.0))


# ----------------------------------------------------------------------------
# Adaptive chunking (host scheduling, copied from the reference)
# ----------------------------------------------------------------------------

def _next_chunk(r2, threshold, rho, chunk: int, rho_fast=None) -> int:
    """Size the next PCG chunk from the observed per-iteration contraction:
    shrink to chunk/4 or chunk/2 when the predicted remainder (1.3x + 3
    margin, with the pessimistic ``rho``) fits, grow to 2x or 4x when even
    the optimistic ``rho_fast`` needs that many. Pure scheduling: the exit
    test is unchanged."""
    if rho is None or not (0.0 < rho < 1.0) or r2 <= threshold or r2 <= 0:
        return chunk
    log_gap = math.log(threshold / r2)
    need = 1.3 * log_gap / math.log(rho) + 3.0
    for div in (4, 2):
        cand = max(chunk // div, 1)
        if cand >= need:
            return cand
    if rho_fast is not None and 0.0 < rho_fast < 1.0:
        need_fast = log_gap / math.log(rho_fast)
        for mult in (4, 2):
            if chunk * mult <= need_fast:
                return chunk * mult
    return chunk


def _update_rho(rho, r2_before, r2_after, iters: int):
    """Per-iteration squared-residual contraction; keeps the WORST observed."""
    if r2_before <= 0 or r2_after <= 0 or r2_after >= r2_before:
        return rho
    new = (r2_after / r2_before) ** (1.0 / max(iters, 1))
    return new if rho is None else max(rho, new)


def _update_rho_fast(rho_fast, r2_before, r2_after, iters: int):
    """Companion BEST (smallest) observed contraction."""
    if r2_before <= 0 or r2_after <= 0 or r2_after >= r2_before:
        return rho_fast
    new = (r2_after / r2_before) ** (1.0 / max(iters, 1))
    return new if rho_fast is None else min(rho_fast, new)


# ----------------------------------------------------------------------------
# Solvers
# ----------------------------------------------------------------------------

class _MGBase:
    """Operators, coarse factorizations and the chunked PCG driver shared by
    the single- and multi-rhs solvers."""

    kind = ""
    cheb_k = 1          # Chebyshev degree of the 3-level coarse solve
    cheb_fine_deg = 0   # Chebyshev fine smoother degree (0: damped Jacobi)

    def __init__(self, pack: MGPack, fine_ell_vals, fine_diag, c1_ell_vals, c1_diag,
                 a2_dense, omega: float, nu: int, c1_band: Optional[BandedC1],
                 c1_bf16: bool = False):
        wd = fine_ell_vals.dtype
        if wd not in (torch.float32, torch.float64):
            raise TypeError(f"working dtype {wd}: float32 or float64")
        self.pack = pack
        self.dtype = wd
        self.c1_band = c1_band
        self.c1_dinv = self.c1_pbelow = None
        self._c1_ok_dev = None
        self._c1_factor_args = None
        self.factor_seconds = 0.0
        device = fine_ell_vals.device
        if c1_band is not None:
            with spans.timed("mg.c1_factor", sync=device) as factor:
                self.c1_dinv, self.c1_pbelow, self._c1_ok_dev = _factor_c1_panels(
                    c1_band, c1_ell_vals.to(wd), c1_diag.to(wd), defer_check=True,
                    bf16=c1_bf16)
                self._c1_factor_args = (c1_band, c1_ell_vals.to(wd), c1_diag.to(wd),
                                        c1_bf16)
            self.factor_seconds = factor.seconds
        n_f, n1 = pack.n_fine, pack.n1
        fine_vals = fine_ell_vals.contiguous()
        c1_vals = c1_ell_vals.to(wd).contiguous()
        self.fine_f32 = EllOp(pack.fine_cols, fine_vals, n_f)
        self.c1_f32 = EllOp(pack.c1_cols, c1_vals, n1)
        if wd == torch.float32:
            # preconditioner-side products stream bfloat16 values
            self.fine_bf = EllOp(pack.fine_cols, bf16_values(fine_vals, pack.fine_canon), n_f)
            self.c1_bf = EllOp(pack.c1_cols, bf16_values(c1_vals, pack.c1_canon), n1)
        else:
            self.fine_bf, self.c1_bf = self.fine_f32, self.c1_f32
        self.f_invd = _inv_diag(fine_diag.to(wd))
        self.c1_invd = _inv_diag(c1_diag.to(wd))
        self.chol2 = None
        if a2_dense is not None:
            a2 = a2_dense.to(wd)
            eps = 1e-7 * torch.max(torch.abs(torch.diagonal(a2)))
            self.chol2 = torch.linalg.cholesky(
                a2 + eps * torch.eye(a2.shape[0], dtype=wd, device=a2.device))
        if self.c1_dinv is None and self.chol2 is None and c1_band is None:
            raise ValueError("need a2_dense when no banded c1 factorization")
        self.omega = omega
        self.nu = nu
        self._rho, self._rho_fast = pack.rho.get(self.kind, (None, None))

    @property
    def c1_l_blocks(self):
        """Non-None iff the exact banded c1 path is active."""
        return self.c1_dinv

    @property
    def gb_per_iter(self) -> float:
        """Streamed GB per outer PCG iteration: the bf16 fine operator 2*nu
        times (nu-1 pre-sweeps, the residual, nu post-sweeps), the f32 fine
        operator once (CG's A p), P0 and P0^T once, and either the banded
        factor panels twice (lower + upper sweep) or 2*nu c1 streams per
        Chebyshev step of the 3-level fallback. Vectors are not counted."""
        nu = self.nu
        if self.cheb_fine_deg > 0 and self.c1_dinv is not None:
            nu = self.cheb_fine_deg
        gb = (2 * nu * self.fine_bf.gigabytes + self.fine_f32.gigabytes
              + self.pack.p0.gigabytes + self.pack.p0t.gigabytes)
        if self.c1_dinv is not None:
            gb += 2 * (self.c1_dinv.numel() * self.c1_dinv.element_size()
                       + self.c1_pbelow.numel() * self.c1_pbelow.element_size()) / 1e9
        else:
            gb += max(self.cheb_k, 1) * 2 * nu * self.c1_bf.gigabytes
        return gb

    # -- hooks of the two forms --------------------------------------------
    def _dots(self, u, v):
        raise NotImplementedError

    def _precondition(self, r):
        raise NotImplementedError

    def _zeros_rz(self, b):
        raise NotImplementedError

    def _chunk(self, x, r, p, rz_old, iters: int):
        """``iters`` PCG iterations with no host sync; returns the state and
        the squared residual norm (max over columns) on the device."""
        for _ in range(iters):
            z = self._precondition(r)
            rz = self._dots(r, z)
            beta = _safe_div(rz, rz_old)
            p = z + beta * p
            ap = self.fine_f32.apply(p)
            alpha = _safe_div(rz, self._dots(p, ap))
            x = x + alpha * p
            r = r - alpha * ap
            rz_old = rz
        return x, r, p, rz_old, torch.max(self._dots(r, r))

    def solve(self, b, x0=None, tol: float = 1e-6, max_iters: int = 200,
              chunk: int = 24, b_norm2: Optional[float] = None):
        if self.c1_dinv is None and self.chol2 is None:
            raise RuntimeError("banded c1 factorization broke down; rebuild with a2_dense")
        self._prepare()
        b_w = b.to(self.dtype)
        if b_norm2 is None:
            b_norm2 = float(torch.max(self._dots(b_w, b_w)))
        if b_norm2 == 0:
            return torch.zeros_like(b), CGStats(0, 0.0)

        def start():
            if x0 is None:
                return torch.zeros_like(b_w), b_w
            x = x0.to(self.dtype)
            return x, b_w - self.fine_f32.apply(x)

        x, r = start()
        p = torch.zeros_like(b_w)
        rz = self._zeros_rz(b_w)
        threshold = (tol ** 2) * b_norm2
        done, r2, undershot = 0, b_norm2, False
        while done < max_iters and r2 > threshold:
            iters = chunk if undershot else _next_chunk(r2, threshold, self._rho, chunk,
                                                        self._rho_fast)
            iters = min(iters, max_iters - done)
            r2_before = r2
            x, r, p, rz, r2_dev = self._chunk(x, r, p, rz, iters)
            r2 = float(r2_dev)
            if self._c1_ok_dev is not None and self.c1_dinv is not None:
                c1_ok = bool(self._c1_ok_dev)
                self._c1_ok_dev = None
                if not c1_ok:
                    _refactor_c1_checked(self)   # raises on total breakdown
                    x, r = start()
                    p = torch.zeros_like(b_w)
                    rz = self._zeros_rz(b_w)
                    done, r2, undershot = 0, b_norm2, False
                    continue
            done += iters
            self._rho = _update_rho(self._rho, r2_before, r2, iters)
            self._rho_fast = _update_rho_fast(self._rho_fast, r2_before, r2, iters)
            self.pack.rho[self.kind] = (self._rho, self._rho_fast)
            undershot = iters < chunk and r2 > threshold
        rel = float(np.sqrt(max(r2, 0.0) / b_norm2))
        return x.to(b.dtype), CGStats(done, rel)

    def _prepare(self) -> None:
        pass


class MG3Solver(_MGBase):
    """The flow solve (port of PallasMG3Solver): single rhs, exact banded c1
    (or the 3-level fallback with a ``cheb_k`` Chebyshev coarse solve)."""

    kind = "s"

    def __init__(self, pack: MGPack, fine_ell_vals, fine_diag, c1_ell_vals, c1_diag,
                 a2_dense, omega: float = 0.7, nu: int = 2, cheb_k: int = 1,
                 c1_band: Optional[BandedC1] = None, cheb_fine_deg: int = 0,
                 c1_bf16: bool = False):
        super().__init__(pack, fine_ell_vals, fine_diag, c1_ell_vals, c1_diag,
                         a2_dense, omega, nu, c1_band, c1_bf16)
        self.cheb_k = int(cheb_k)
        self.cheb_fine_deg = int(cheb_fine_deg)
        self._fine_bounds = None
        self._cheb_bounds = None

    def _dots(self, u, v):
        return torch.dot(u, v)

    def _zeros_rz(self, b):
        return torch.zeros((), dtype=self.dtype, device=b.device)

    def cheb_bounds(self):
        if self._cheb_bounds is None:
            self._cheb_bounds = _cheb_bounds(self)
        return self._cheb_bounds

    def _prepare(self) -> None:
        if self.c1_dinv is not None and self.cheb_fine_deg > 0 and self._fine_bounds is None:
            lmax = _fine_lmax(self)
            self._fine_bounds = (lmax / 8.0, lmax)

    def _precondition(self, r):
        if self.c1_dinv is not None:
            f_lmin, f_lmax = self._fine_bounds or (None, None)
            return _cycle_exact(self.fine_bf, self.f_invd, self.c1_dinv, self.c1_pbelow,
                                self.c1_band, self.pack, r, self.omega, self.nu,
                                self.cheb_fine_deg, f_lmin, f_lmax)
        if self.cheb_k > 1:
            lmin, lmax = self.cheb_bounds()
        else:
            lmin = lmax = 1.0
        return _cycle(self.fine_bf, self.f_invd, self.c1_bf, self.c1_invd, self.chol2,
                      self.pack, r, self.omega, self.nu, self.cheb_k, lmin, lmax)


class MG3MultiSolver(_MGBase):
    """The smoothing and DoG solves (port of PallasMG3MultiSolver): C <= 8
    right-hand sides, exact banded c1 or the plain 3-level fallback."""

    kind = "m"

    def __init__(self, pack: MGPack, fine_ell_vals, fine_diag, c1_ell_vals, c1_diag,
                 a2_dense, omega: float = 0.7, nu: int = 2,
                 c1_band: Optional[BandedC1] = None, c1_bf16: bool = False):
        super().__init__(pack, fine_ell_vals, fine_diag, c1_ell_vals, c1_diag,
                         a2_dense, omega, nu, c1_band, c1_bf16)
        self.f_invd = self.f_invd[:, None]
        self.c1_invd = self.c1_invd[:, None]

    def _dots(self, u, v):
        return (u * v).sum(dim=0)

    def _zeros_rz(self, b):
        return torch.zeros(b.shape[1], dtype=self.dtype, device=b.device)

    def _precondition(self, r):
        if self.c1_dinv is not None:
            return _cycle_exact(self.fine_bf, self.f_invd, self.c1_dinv, self.c1_pbelow,
                                self.c1_band, self.pack, r, self.omega, self.nu)
        return _cycle(self.fine_bf, self.f_invd, self.c1_bf, self.c1_invd, self.chol2,
                      self.pack, r, self.omega, self.nu)

    def solve(self, b, x0=None, tol: float = 1e-7, max_iters: int = 200,
              chunk: int = 16, b_norm2: Optional[float] = None):
        if b.dim() != 2 or not 1 <= b.shape[1] <= 8:
            raise ValueError(f"MG3MultiSolver takes (n, C<=8) right-hand sides, got "
                             f"{tuple(b.shape)}")
        return super().solve(b, x0=x0, tol=tol, max_iters=max_iters, chunk=chunk,
                             b_norm2=b_norm2)
