"""Generalized eigensolver for the vector-field Laplacian spectrum.

Port of meshopticalflow_tpu/solvers/lanczos.py, the replacement of the
reference's ARPACK++ shift-invert solver (Src/EigenvalueSolver.h:79-219,
Src/VectorLaplacianSpectrum.inl): the lowest-k pairs of S x = lambda M x,
with S a basis smoothness operator (padded ELL) and M = P^T (g * area) P the
vector-field mass pulled back through the prolongation
(VectorLaplacianSpectrum.inl:9-19).

Method: Lanczos with full reorthogonalization in the M inner product on
op(x) = (S + sigma M)^{-1} M x, restarted and deflated against accepted
pairs; lambda = 1/theta - sigma for Ritz values theta, re-derived as
Rayleigh quotients of host float64 copies of S and M, which accept or reject
every candidate. Three recurrences, as in the reference package:

  * ``_lanczos``: one vector per step, Jacobi-PCG inner solves to tolerance
    (``compute_spectrum(host_stepped=False)``, the CPU default);
  * ``_lanczos_host``: one vector per step, inner solves preconditioned by a
    banded Cholesky factor of S + sigma M (``ShiftInvertPack``): fixed-trip
    solves in ladder blocks of steps when the factor's probed contraction
    allows, tolerance-driven ones otherwise;
  * ``_lanczos_host_block``: block Lanczos (``block`` vectors per step) with
    the same fixed-trip banded inner solves and Cholesky QR of each new
    block, the path ``compute_spectrum`` takes on CUDA.

Within a ladder block nothing is read back: the recurrence scalars stay
device tensors, and a Cholesky breakdown becomes NaNs that the host
truncates after the fact. The shape ladders of the reference (Lanczos block
steps, deflation width, purification width, inner trip counts) are kept:
they set the Krylov depth and trip counts, and so the arithmetic.
"""

from __future__ import annotations

import time
import weakref
from typing import NamedTuple, Optional

import numpy as np
import scipy.sparse as sp
import torch

from meshopticalflow_tpu_torch.models.base import (BasisDevice, data_term_ell_vals,
                                                   prolong, restrict)
from meshopticalflow_tpu_torch.ops.ell import ell_matvec
from meshopticalflow_tpu_torch.solvers.banded import (
    BandedCholeskySolver, _bpcg_chunk, bpcg_probe, build_band_pattern, ell_pcg_banded,
    ell_pcg_banded_multi)
from meshopticalflow_tpu_torch.solvers.cg import ell_pcg, pcg_multi


class SpectrumResult(NamedTuple):
    eigenvalues: np.ndarray        # (k,) ascending
    coefficients: np.ndarray       # (k, n_coeffs) basis coefficients
    triangle_fields: np.ndarray    # (k, T, 2) prolonged per-triangle fields


def _mass_matvec(basis: BasisDevice, mass_blocks: torch.Tensor, x: torch.Tensor):
    """M x with M = P^T diag(g*area) P."""
    y = prolong(basis, x)
    return restrict(basis, torch.einsum("tab,tb->ta", mass_blocks, y))


def _mass_diag(basis: BasisDevice, mass_blocks: torch.Tensor) -> torch.Tensor:
    contrib = torch.einsum("tak,tab,tbk->tk", basis.p_wt, mass_blocks, basis.p_wt)
    out = torch.zeros(basis.n_coeffs, dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(0, basis.p_idx.reshape(-1), contrib.reshape(-1))


def _prolong_multi(basis: BasisDevice, x: torch.Tensor) -> torch.Tensor:
    """P X for X (n, C) -> (C, T, 2), one pass for every eigenvector."""
    y = torch.einsum("tak,tkc->tac", basis.p_wt, x[basis.p_idx])
    return y.permute(2, 0, 1)


def _mass_matvec_multi(basis: BasisDevice, mass_blocks: torch.Tensor, x: torch.Tensor):
    """M X for X (n, C): columnwise prolong/restrict."""
    y = torch.einsum("tak,tkc->tac", basis.p_wt, x[basis.p_idx])
    gy = torch.einsum("tab,tbc->tac", mass_blocks, y)
    contrib = torch.einsum("tak,tac->tkc", basis.p_wt, gy)
    out = torch.zeros((basis.n_coeffs, x.shape[1]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, basis.p_idx.reshape(-1), contrib.reshape(-1, x.shape[1]))


def _rr_grams(basis: BasisDevice, mass_blocks, pure):
    """Rayleigh-Ritz Gram matrices (pure^T S pure, pure^T M pure) on the
    device: the (n, take_q) block itself never goes to the host."""
    sb = ell_matvec(basis.ell_cols, basis.s_vals, pure)
    mb = _mass_matvec_multi(basis, mass_blocks, pure)
    return pure.T @ sb, pure.T @ mb


def _cand_from_krylov(big_v, y_pad, cut: int):
    """Ritz candidates big_v[:cut].T @ y at a fixed shape: rows at or past
    ``cut`` are masked to zero (they may hold post-breakdown inf/NaN), and
    y_pad is zero there too."""
    mask = (torch.arange(big_v.shape[0], device=big_v.device) < cut)[:, None]
    return torch.where(mask, big_v, torch.zeros_like(big_v)).T @ y_pad


def _diag_of(basis: BasisDevice, vals: torch.Tensor) -> torch.Tensor:
    return torch.gather(vals, 1, basis.diag_slot[:, None])[:, 0]


def _reorthogonalize(w, big_v, big_mv, defl_v, defl_mv):
    """Full M-reorthogonalization against the stored Krylov rows and the
    deflation block, twice; rows not yet filled are zero."""
    for _ in range(2):
        w = w - big_v.T @ (big_mv @ w)
        w = w - defl_v.T @ (defl_mv @ w)
    return w


def _normalize(w, beta):
    return w / torch.where(beta > 1e-30, beta, torch.ones_like(beta))


def _lanczos(basis: BasisDevice, mass_blocks, sigma, v0, defl_v, defl_mv, m: int,
             cg_tol: float, cg_max_iters: int):
    """``m`` Lanczos steps with Jacobi-PCG inner solves to ``cg_tol``,
    convergence tested every iteration as the reference's while loop does;
    the operator is S + sigma M assembled on the ELL layout (one SpMV an
    iteration). Returns (big_v (m, n), alphas (m,), betas (m,))."""
    n = basis.n_coeffs
    kw = dict(dtype=basis.s_vals.dtype, device=basis.s_vals.device)
    sys = _shift_invert_pack(basis, mass_blocks, sigma, inner="jacobi")

    def mass_mv(x):
        return _mass_matvec(basis, mass_blocks, x)

    v = v0 - defl_v.T @ (defl_mv @ v0)
    v = v / torch.sqrt(torch.dot(v, mass_mv(v)))
    big_v = torch.zeros((m, n), **kw)
    big_mv = torch.zeros((m, n), **kw)
    alphas = torch.zeros(m, **kw)
    betas = torch.zeros(m, **kw)
    beta_prev, v_prev = torch.zeros((), **kw), torch.zeros(n, **kw)
    for j in range(m):
        mv = mass_mv(v)
        w, _ = ell_pcg(basis.ell_cols, sys.sys_vals, sys.diag, mv, tol=cg_tol,
                       max_iters=cg_max_iters, chunk=1)
        alphas[j], betas[j], v_next = _lanczos_host_step(
            basis, mass_blocks, big_v, big_mv, defl_v, defl_mv, v, mv, w, beta_prev, v_prev, j)
        v_prev, v, beta_prev = v, v_next, betas[j]
    return big_v, alphas, betas


def _lanczos_host_step(basis: BasisDevice, mass_blocks, big_v, big_mv, defl_v, defl_mv,
                       v, mv, w_raw, beta_prev, v_prev, j: int):
    """The orthogonalization of Lanczos step j, shared by the single-vector
    recurrences: given mv = M v and the inner solve's w_raw = op(v), store
    row j, take alpha, the three-term recurrence and the full
    reorthogonalization, and return (alpha, beta, next v) as device
    tensors."""
    big_v[j] = v
    big_mv[j] = mv
    alpha = torch.dot(w_raw, mv)
    w = w_raw - alpha * v - beta_prev * v_prev
    w = _reorthogonalize(w, big_v, big_mv, defl_v, defl_mv)
    beta = torch.sqrt(torch.clamp(torch.dot(w, _mass_matvec(basis, mass_blocks, w)), min=0.0))
    return alpha, beta, _normalize(w, beta)


def _lanczos_banded_block(basis: BasisDevice, mass_blocks, pack: "ShiftInvertPack",
                          big_v, big_mv, alphas, betas, defl_v, defl_mv, v, beta_prev,
                          v_prev, j0: int, steps: int):
    """``steps`` complete Lanczos steps with fixed-trip (``pack.inner_iters``)
    banded-PCG inner solves, reading nothing back: alphas and betas fill
    device tensors, and breakdown (a tiny beta, a non-finite coefficient)
    is cut by the caller after the block. Returns the carried state."""
    solver = pack.bsolver
    for t in range(steps):
        j = j0 + t
        mv = _mass_matvec(basis, mass_blocks, v)
        z = solver.solve(mv).to(mv.dtype)
        w_raw = _bpcg_chunk(basis.ell_cols, pack.sys_vals, solver, torch.zeros_like(mv),
                            mv, z, z, torch.dot(mv, z), pack.inner_iters)[0]
        alphas[j], betas[j], v_next = _lanczos_host_step(
            basis, mass_blocks, big_v, big_mv, defl_v, defl_mv, v, mv, w_raw, beta_prev,
            v_prev, j)
        v_prev, v, beta_prev = v, v_next, betas[j]
    return v, beta_prev, v_prev


def _cholesky_nan(g: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of g, all NaN where g is not positive definite
    (the breakdown signal of the block recurrence). ``info`` stays on the
    device: nothing is read back."""
    l_f, info = torch.linalg.cholesky_ex(g)
    return torch.where(info == 0, l_f, torch.full_like(l_f, float("nan")))


def _lanczos_banded_blockstep(basis: BasisDevice, mass_blocks, pack: "ShiftInvertPack",
                              big_v, big_mv, a_blk, b_blk, defl_v, defl_mv, x_cur, b_prev,
                              x_prev, j0: int, steps: int, bs: int):
    """``steps`` block-Lanczos steps of block size ``bs``, reading nothing
    back. Per step: multi-rhs mass product, fixed-trip banded-PCG block
    solve, A_j = (M X_j)^T W, the three-term recurrence, full
    M-reorthogonalization, and M-orthonormalization of the new block by
    Cholesky QR (G = W^T M W = L L^T, X_{j+1} = W L^{-T}, B_{j+1} = L^T).
    A singular G surfaces as NaNs, which the caller's cut truncates."""
    solver = pack.bsolver
    for t in range(steps):
        j = j0 + t
        mx = _mass_matvec_multi(basis, mass_blocks, x_cur)            # (n, bs)
        z = solver.solve(mx).to(mx.dtype)
        w = _bpcg_chunk(basis.ell_cols, pack.sys_vals, solver, torch.zeros_like(mx), mx,
                        z, z, torch.sum(mx * z, dim=0), pack.inner_iters)[0]
        big_v[j * bs:(j + 1) * bs] = x_cur.T
        big_mv[j * bs:(j + 1) * bs] = mx.T
        a_j = mx.T @ w                                                # (bs, bs)
        w = w - x_cur @ a_j - x_prev @ b_prev.T
        w = _reorthogonalize(w, big_v, big_mv, defl_v, defl_mv)
        g = w.T @ _mass_matvec_multi(basis, mass_blocks, w)
        l_f = _cholesky_nan((g + g.T) / 2)
        x_next = torch.linalg.solve_triangular(l_f, w.T, upper=False).T
        b_next = l_f.T
        a_blk[j] = a_j
        b_blk[j] = b_next
        x_prev, b_prev, x_cur = x_cur, b_next, x_next
    return x_cur, b_prev, x_prev


def _block_init(basis: BasisDevice, mass_blocks, x0, defl_v, defl_mv):
    """Deflate and M-orthonormalize the starting block (Cholesky QR). A tiny
    ridge keeps a rank-deficient random start factorable; the recurrence's
    own QR gets none (its NaNs are the breakdown signal)."""
    x = x0 - defl_v.T @ (defl_mv @ x0)
    g = x.T @ _mass_matvec_multi(basis, mass_blocks, x)
    g = (g + g.T) / 2
    g = g + 1e-12 * torch.trace(g) * torch.eye(g.shape[0], dtype=g.dtype, device=g.device)
    l_f = _cholesky_nan(g)
    return torch.linalg.solve_triangular(l_f, x.T, upper=False).T


def _block_ladder(q: int):
    """Dispatch blocks of block steps from the {16, 8, 4} ladder, rounding
    ``q`` up (surplus steps are extra Krylov work)."""
    blocks = []
    rem = q
    while rem >= 16:
        blocks.append(16)
        rem -= 16
    if rem > 12:
        blocks.append(16)
    elif rem > 8:
        blocks.extend([8, 4])
    elif rem > 4:
        blocks.append(8)
    elif rem > 0:
        blocks.append(4)
    return blocks


def _lanczos_host_block(basis: BasisDevice, mass_blocks, x0, defl_v, defl_mv, m: int,
                        pack: "ShiftInvertPack", bs: int = 4,
                        m_alloc: Optional[int] = None):
    """Block Lanczos on the banded shift-invert operator. Returns (big_v
    (m_alloc, n), t_mat (cut, cut) float64, cut) with the block-tridiagonal
    matrix assembled and truncated at breakdown on the host, after one read
    of the coefficients."""
    n = basis.n_coeffs
    kw = dict(dtype=basis.s_vals.dtype, device=basis.s_vals.device)
    blocks = _block_ladder(-(-m // bs))
    q_pad = sum(blocks)
    m_alloc = max(m_alloc or 0, q_pad * bs)
    q_alloc = m_alloc // bs

    x_cur = _block_init(basis, mass_blocks, x0, defl_v, defl_mv)
    big_v = torch.zeros((m_alloc, n), **kw)
    big_mv = torch.zeros((m_alloc, n), **kw)
    a_blk = torch.zeros((q_alloc, bs, bs), **kw)
    b_blk = torch.zeros((q_alloc, bs, bs), **kw)
    b_prev = torch.zeros((bs, bs), **kw)
    x_prev = torch.zeros((n, bs), **kw)
    j0 = 0
    for steps in blocks:
        x_cur, b_prev, x_prev = _lanczos_banded_blockstep(
            basis, mass_blocks, pack, big_v, big_mv, a_blk, b_blk, defl_v, defl_mv,
            x_cur, b_prev, x_prev, j0, steps, bs)
        j0 += steps

    a_h = a_blk.double().cpu().numpy()
    b_h = b_blk.double().cpu().numpy()
    # Truncate at block granularity before the first block with non-finite
    # coefficients (a QR breakdown), coefficient explosion (the
    # semi-definite-M regime), or after an exhausted subspace (a tiny B
    # diagonal).
    scale0 = float(np.median(np.abs(np.diagonal(a_h[0])))) + 1e-300
    q_keep = 0
    for j in range(q_pad):
        if not (np.isfinite(a_h[j]).all() and np.isfinite(b_h[j]).all()):
            break
        if np.abs(a_h[j]).max() > 1e8 * scale0 or np.abs(b_h[j]).max() > 1e8 * scale0:
            break
        q_keep = j + 1
        if np.abs(np.diagonal(b_h[j])).min() < 1e-14 * scale0:
            break
    q_keep = max(q_keep, 1)
    cut = q_keep * bs
    t_mat = np.zeros((cut, cut))
    for j in range(q_keep):
        t_mat[j * bs:(j + 1) * bs, j * bs:(j + 1) * bs] = (a_h[j] + a_h[j].T) / 2
        if j + 1 < q_keep:
            t_mat[(j + 1) * bs:(j + 2) * bs, j * bs:(j + 1) * bs] = b_h[j]
            t_mat[j * bs:(j + 1) * bs, (j + 1) * bs:(j + 2) * bs] = b_h[j].T
    return big_v, t_mat, cut


# RCM band patterns keyed by the ELL cols tensor, weakref-guarded against id
# reuse and bounded.
_BAND_PAT_CACHE: dict = {}


def _band_pattern_for(ell_cols: torch.Tensor):
    key = id(ell_cols)
    ent = _BAND_PAT_CACHE.get(key)
    if ent is None or ent[0]() is not ell_cols:
        pat = build_band_pattern(ell_cols.cpu().numpy())
        _BAND_PAT_CACHE[key] = (weakref.ref(ell_cols), pat)
        if len(_BAND_PAT_CACHE) > 4:
            _BAND_PAT_CACHE.pop(next(iter(_BAND_PAT_CACHE)))
        return pat
    return ent[1]


class ShiftInvertPack(NamedTuple):
    """The shift-invert system S + sigma M on the ELL layout and (when the
    factorization succeeds) its banded Cholesky preconditioner, built once
    per sigma and shared by every restart and the purification solve.
    ``inner_iters`` is the fixed trip count of the inner solves, sized from
    the preconditioner's probed contraction (0: too weak for fixed trips)."""
    sys_vals: torch.Tensor
    diag: torch.Tensor
    bsolver: Optional[BandedCholeskySolver]
    inner_iters: int = 32


def _shift_invert_pack(basis: BasisDevice, mass_blocks, sigma, inner: str = "banded",
                       tol: float = 1e-9) -> ShiftInvertPack:
    # The exact sigma*M on the ELL layout: M = P^T diag(g*area) P shares the
    # R D P pattern the basis already unions into ell_cols
    # (EigenvalueSolver.h:176-178 semantics, no diagonal substitution).
    sigma_m = data_term_ell_vals(basis, sigma * mass_blocks)
    sys_vals = basis.s_vals + sigma_m.reshape(basis.ell_cols.shape)
    diag = _diag_of(basis, sys_vals)

    bsolver = None
    if inner == "banded":
        pat = _band_pattern_for(basis.ell_cols)
        try:
            bsolver = BandedCholeskySolver(pat, sys_vals.device).factor(sys_vals)
        except RuntimeError:
            bsolver = None   # breakdown at every shift: Jacobi inner solves

    inner_iters = 32
    if bsolver is not None:
        # Size the fixed-trip inner solves from the measured contraction of
        # the preconditioner on this system: the median per-step ||r||^2
        # ratio over the converging prefix of a probe on a seeded random
        # rhs, and the count that reaches ``tol``. A factor too weak to get
        # there within 48 trips stores 0: the caller then takes the
        # tolerance-driven solves (the fixed trips check no residual).
        probe_rhs = torch.as_tensor(np.random.default_rng(12345).normal(size=bsolver.pat.n)
                                    ).to(dtype=sys_vals.dtype, device=sys_vals.device)
        hist = np.maximum(bpcg_probe(basis.ell_cols, sys_vals, bsolver, probe_rhs, 12)
                          .double().cpu().numpy(), 1e-300)
        live = hist > hist[0] * 1e-17   # leave out the f32 stagnation floor
        ratios = (hist[1:] / hist[:-1])[live[1:]]
        rho2 = float(np.median(ratios)) if len(ratios) else 1.0
        target = float(min(tol, 1e-9)) ** 2
        if rho2 < 1.0:
            needed = int(np.ceil(np.log(target) / np.log(max(rho2, 1e-30)))) + 2
        else:
            needed = 10 ** 9
        # Bucketed up to a fixed ladder, as in the reference.
        if needed <= 48:
            inner_iters = next(b for b in (8, 12, 16, 24, 32, 48) if b >= max(6, needed))
        else:
            inner_iters = 0
    return ShiftInvertPack(sys_vals, diag, bsolver, inner_iters)


def _ladder_blocks(m: int):
    """A Lanczos depth as dispatch blocks from the {64, 32, 16} ladder,
    rounded up to the next reachable sum (the padded depth is what the
    caller allocates)."""
    blocks = []
    rem = m
    while rem >= 64:
        blocks.append(64)
        rem -= 64
    if rem > 32:
        blocks.extend([32, 16])
    elif rem > 16:
        blocks.append(32)
    elif rem > 0:
        blocks.append(16)
    return blocks


def _lanczos_host(basis: BasisDevice, mass_blocks, sigma, v0, defl_v, defl_mv, m: int,
                  cg_tol: float, cg_max_iters: int, inner: str = "banded",
                  pack: Optional[ShiftInvertPack] = None, m_alloc: Optional[int] = None):
    """Single-vector Lanczos on the banded shift-invert operator: ladder
    blocks of fixed-trip steps (``_lanczos_banded_block``) when the pack's
    probe sized a trip count, else tolerance-driven inner solves step by
    step (banded PCG, or Jacobi PCG without a factor), reading alpha and
    beta each step. Returns (big_v, alphas, betas)."""
    n = basis.n_coeffs
    kw = dict(dtype=basis.s_vals.dtype, device=basis.s_vals.device)
    if pack is None:
        pack = _shift_invert_pack(basis, mass_blocks, sigma, inner, tol=cg_tol)
    bsolver = pack.bsolver
    blocks = _ladder_blocks(m)
    m_alloc = max(m_alloc or 0, sum(blocks) if blocks else m)

    v = v0 - defl_v.T @ (defl_mv @ v0)
    v = v / torch.sqrt(torch.dot(v, _mass_matvec(basis, mass_blocks, v)))
    big_v = torch.zeros((m_alloc, n), **kw)
    big_mv = torch.zeros((m_alloc, n), **kw)
    v_prev = torch.zeros(n, **kw)
    beta_prev = torch.zeros((), **kw)

    inner_iters = min(pack.inner_iters, cg_max_iters)
    if bsolver is not None and inner_iters > 0:
        pack = pack._replace(inner_iters=inner_iters)
        alphas = torch.zeros(m_alloc, **kw)
        betas = torch.zeros(m_alloc, **kw)
        j0 = 0
        for steps in blocks:
            v, beta_prev, v_prev = _lanczos_banded_block(
                basis, mass_blocks, pack, big_v, big_mv, alphas, betas, defl_v, defl_mv,
                v, beta_prev, v_prev, j0, steps)
            j0 += steps
        return big_v, alphas, betas

    alphas = np.zeros(m_alloc)
    betas = np.zeros(m_alloc)
    for j in range(m):
        b = _mass_matvec(basis, mass_blocks, v)
        if bsolver is not None:
            w_raw, _ = ell_pcg_banded(basis.ell_cols, pack.sys_vals, bsolver, b, tol=cg_tol,
                                      max_iters=min(cg_max_iters, 400))
        else:
            w_raw, _ = ell_pcg(basis.ell_cols, pack.sys_vals, pack.diag, b, tol=cg_tol,
                               max_iters=cg_max_iters, chunk=256)
        alpha, beta, v_next = _lanczos_host_step(basis, mass_blocks, big_v, big_mv, defl_v,
                                                 defl_mv, v, b, w_raw, beta_prev, v_prev, j)
        alphas[j] = float(alpha)
        betas[j] = float(beta)
        if betas[j] < 1e-14:
            break
        v_prev, v, beta_prev = v, v_next, beta
    return big_v, torch.as_tensor(alphas), torch.as_tensor(betas)


def _host_operators(basis: BasisDevice, mass_blocks):
    """Float64 scipy copies of S and M from one device-to-host copy of the
    basis tensors: (S, M, ||S||_inf, ||M||_inf)."""
    ell_cols = basis.ell_cols.cpu().numpy()
    s_vals = basis.s_vals.double().cpu().numpy()
    p_idx = basis.p_idx.cpu().numpy()
    p_wt = basis.p_wt.double().cpu().numpy()
    mass = mass_blocks.double().cpu().numpy()
    nh, wh = ell_cols.shape
    s64 = sp.csr_matrix((s_vals.ravel(), (np.repeat(np.arange(nh), wh), ell_cols.ravel())),
                        shape=(nh, nh))
    t, kh = p_idx.shape
    prows = np.repeat(np.arange(2 * t).reshape(t, 2), kh, axis=1).ravel()
    pcols = np.repeat(p_idx[:, None, :], 2, axis=1).ravel()
    p64 = sp.coo_matrix((p_wt.ravel(), (prows, pcols)), shape=(2 * t, nh)).tocsr()
    g64 = sp.bsr_matrix((mass, np.arange(t), np.arange(t + 1)), shape=(2 * t, 2 * t))
    m64 = (p64.T @ (g64 @ p64)).tocsr()
    return (s64, m64, float(np.abs(s64).sum(axis=1).max()),
            float(np.abs(m64).sum(axis=1).max()))


def compute_spectrum(
    basis: BasisDevice,
    mass_blocks: torch.Tensor,    # (T, 2, 2) per-triangle g * area
    k: int,
    sigma: float = 1e-8,
    max_lanczos: Optional[int] = None,
    cg_tol: float = 1e-10,
    cg_max_iters: int = 20000,
    seed: int = 0,
    max_restarts: Optional[int] = None,
    host_stepped: bool = False,
    block: int = 4,
    stats: Optional[dict] = None,
) -> SpectrumResult:
    """Lowest-k eigenpairs of S x = lambda M x (ComputeSpectrum,
    VectorLaplacianSpectrum.inl:5-41).

    Restarted deflated Lanczos: each restart deflates against the accepted
    eigenvectors, which resolves degenerate clusters a single Krylov
    sequence cannot (ARPACK's implicit restarts play that role).
    ``host_stepped`` takes the banded shift-invert paths, block Lanczos when
    ``block`` > 1; otherwise the Jacobi-PCG recurrence. ``stats`` (when
    given) receives the shift-invert pack's seconds and probed trip count,
    the sigma escalations, the whole call's seconds and, per restart, the
    seconds of the Lanczos blocks, purification, Rayleigh-Ritz and
    acceptance, the deflation width and (block path) the Krylov rows
    allocated."""
    t_call = time.perf_counter()
    n = basis.n_coeffs
    dtype, device = basis.s_vals.dtype, basis.s_vals.device
    m = max_lanczos or min(n, max(3 * k + 20, 50))
    rng = np.random.default_rng(seed)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(dtype=dtype, device=device)

    # Host float64 S and M decide acceptance: device-dtype residuals hide the
    # vector quality behind the product's own rounding (in float32 nothing
    # would ever be accepted on the demo mesh).
    s64, m64, s_norm, m_norm = _host_operators(basis, mass_blocks)
    eps_dtype = float(torch.finfo(dtype).eps)

    # The shift must register in the compute dtype: sigma*||M|| has to
    # clear eps*||S||. Eigenvalues do not depend on it (they are Rayleigh
    # quotients of S, M); it stays well below lambda_1.
    sigma_eff = max(float(sigma), 4.0 * eps_dtype * s_norm / max(m_norm, 1e-300))
    sig = torch.tensor(sigma_eff, dtype=dtype, device=device)
    s_diag = _diag_of(basis, basis.s_vals)
    adiag = s_diag + sig * _mass_diag(basis, mass_blocks)

    def a_mv_multi(x):
        return ell_matvec(basis.ell_cols, basis.s_vals, x) \
            + sig * _mass_matvec_multi(basis, mass_blocks, x)

    def new_pack():
        t0 = time.perf_counter()
        p = _shift_invert_pack(basis, mass_blocks, sigma_eff, tol=cg_tol)
        if stats is not None:
            stats.setdefault("packs", []).append(dict(
                sigma=sigma_eff, seconds=time.perf_counter() - t0,
                inner_iters=p.inner_iters, banded=p.bsolver is not None,
                shift_used=None if p.bsolver is None else p.bsolver.shift_used))
        return p

    pack = new_pack() if host_stepped else None

    # Acceptance measures the relative residual less a dtype-eps absolute
    # allowance: without it a nullspace pair (lam = 0) could never pass, and
    # in float32 the vector-error floor sits above any sane threshold.
    res_floor = (1e4 if eps_dtype > 1e-10 else 1e6) * eps_dtype * s_norm

    accepted_lams: list = []
    accepted: list = []      # M-normalized eigenvectors (float64)
    accepted_m: list = []    # M times those vectors
    max_restarts = max_restarts if max_restarts is not None else 2 * k + 4
    stagnant = 0
    sigma_bumps = 0
    near_miss = None         # best rejected candidate; seeds the next restart
    near_miss_lam = None
    restarts = [] if stats is None else stats.setdefault("restarts", [])

    for restart in range(max_restarts):
        rec = dict(restart=restart, accepted_before=len(accepted), sigma=sigma_eff)
        t_stage = time.perf_counter()
        # Once k pairs are accepted, a restart only confirms nothing hides
        # below the k-th: a short subspace does, unless a pending near-miss
        # below the k-th asks for a full-depth seeded restart.
        confirm = len(accepted) >= k
        if confirm and near_miss is not None:
            kth0 = np.sort(np.array(accepted_lams))[k - 1]
            if near_miss_lam <= kth0 * (1 - 1e-6):
                confirm = False
        m_r = m if not confirm else min(m, max(32, k + 16))
        # Deflation block of a 16-quantized width that only grows.
        n_defl = 16 * (-(-(k + 2) // 16))
        if len(accepted) + 2 > n_defl:
            n_defl = 16 * (-(-(len(accepted) + 2) // 16))
        defl_v_h = np.zeros((n_defl, n))
        defl_mv_h = np.zeros((n_defl, n))
        for i, (u, mu) in enumerate(zip(accepted, accepted_m)):
            defl_v_h[i] = u
            defl_mv_h[i] = mu
        defl_v, defl_mv = dev(defl_v_h), dev(defl_mv_h)
        rec["deflation_width"] = n_defl
        if near_miss is not None and restart % 2 == 1:
            # Odd restarts refine the best near-converged candidate; even ones
            # stay random (more copies of a degenerate cluster only appear in
            # fresh Krylov spaces).
            v0 = dev(near_miss + 1e-3 * rng.normal(size=n))
            near_miss = None
        else:
            v0 = dev(rng.normal(size=n))
        blocked = (host_stepped and block > 1 and pack is not None
                   and pack.bsolver is not None and pack.inner_iters > 0)
        if blocked:
            x0_blk = dev(np.concatenate([v0.double().cpu().numpy()[:, None],
                                         rng.normal(size=(n, block - 1))], axis=1))
            m_alloc_blk = block * (16 * (-(-(-(-m // block)) // 16)))
            rec.update(block=block, m_alloc=m_alloc_blk)
            big_v, t_mat, cut = _lanczos_host_block(basis, mass_blocks, x0_blk, defl_v,
                                                    defl_mv, m_r, pack, bs=block,
                                                    m_alloc=m_alloc_blk)
        else:
            if host_stepped:
                big_v, alphas, betas = _lanczos_host(
                    basis, mass_blocks, sig, v0, defl_v, defl_mv, m_r, cg_tol,
                    cg_max_iters, pack=pack, m_alloc=sum(_ladder_blocks(m)))
            else:
                big_v, alphas, betas = _lanczos(basis, mass_blocks, sig, v0, defl_v,
                                                defl_mv, m_r, cg_tol, cg_max_iters)
            alphas = alphas.double().cpu().numpy()
            betas = betas.double().cpu().numpy()
            # Truncate at breakdown: a non-finite coefficient, a tiny beta
            # (invariant subspace), or coefficient explosion (the
            # semi-definite-M regime near Krylov exhaustion).
            cut = m_r
            bad = np.nonzero(~np.isfinite(alphas) | ~np.isfinite(betas))[0]
            if len(bad):
                cut = min(cut, max(int(bad[0]), 1))
            tiny = np.nonzero(betas[:max(cut - 1, 0)] < 1e-14)[0]
            if len(tiny):
                cut = min(cut, int(tiny[0]) + 1)
            scale0 = float(np.median(np.abs(alphas[:min(8, cut)]))) + 1e-300
            grow = np.nonzero((np.abs(alphas[:cut]) > 1e8 * scale0)
                              | (betas[:cut] > 1e8 * scale0))[0]
            if len(grow):
                cut = min(cut, max(int(grow[0]), 1))
            t_mat = np.diag(alphas[:cut])
            if cut > 1:
                t_mat += np.diag(betas[:cut - 1], 1) + np.diag(betas[:cut - 1], -1)
        rec.update(lanczos_s=time.perf_counter() - t_stage, depth=m_r, cut=cut)
        t_stage = time.perf_counter()
        theta, y = np.linalg.eigh(t_mat)
        order = np.argsort(theta)[::-1]
        theta_sorted = theta[order]
        with np.errstate(divide="ignore"):
            lams_all = 1.0 / np.where(np.abs(theta_sorted) > 1e-300, theta_sorted,
                                      1e-300) - sigma_eff
        # Ritz candidates on the device, at a 32-quantized column count; then
        # purification: one application of (S + sigma M)^{-1} M / theta
        # removes the null(M) components a semi-definite M leaves in them.
        take = min(cut, 2 * k + 10)
        usable = np.abs(theta_sorted[:take]) > 1e-30
        take_q = 32 * (-(-take // 32))
        y_pad = np.zeros((int(big_v.shape[0]), take_q))
        y_pad[:cut, :take] = y[:, order[:take]]
        cand_t = _cand_from_krylov(big_v, dev(y_pad), cut)
        if accepted:
            # M-deflate the accepted pairs first: purification would amplify
            # their residual components by (lam + sigma) / (lam_acc + sigma).
            cand_t = cand_t - defl_v.T @ (defl_mv @ cand_t)
        b = _mass_matvec_multi(basis, mass_blocks, cand_t)
        if pack is not None and pack.bsolver is not None:
            pure, _ = ell_pcg_banded_multi(basis.ell_cols, pack.sys_vals, pack.bsolver, b,
                                           tol=cg_tol, max_iters=min(cg_max_iters, 400),
                                           chunk=pack.inner_iters + 4)
        else:
            pure, _ = pcg_multi(a_mv_multi, b, adiag, tol=cg_tol, max_iters=cg_max_iters)
        theta_scale = np.zeros(take_q)
        theta_scale[:take] = np.where(usable, 1.0, 0.0) / np.where(usable, theta_sorted[:take],
                                                                   1.0)
        pure = pure * dev(theta_scale)[None, :]
        rec["purify_s"] = time.perf_counter() - t_stage
        t_stage = time.perf_counter()
        # Rayleigh-Ritz on the purified block unmixes degenerate clusters;
        # the Grams form on the device in the compute dtype.
        hs_d, hm_d = _rr_grams(basis, mass_blocks, pure)
        hs = hs_d.double().cpu().numpy()
        hm = hm_d.double().cpu().numpy()
        hs = (hs + hs.T) / 2
        hm = (hm + hm.T) / 2
        dm, qm = np.linalg.eigh(hm)
        keep = dm > max(dm.max(), 0) * 1e-10
        lams_all = np.concatenate([lams_all[:take], np.full(take_q - take, np.inf)])
        usable = np.concatenate([usable, np.zeros(take_q - take, bool)])
        if keep.any():
            wq = qm[:, keep] / np.sqrt(dm[keep])[None, :]
            theta2, z2 = np.linalg.eigh(wq.T @ hs @ wq)
            mix = np.zeros((take_q, take_q))
            mix[:, :wq.shape[1]] = wq @ z2
            pure = pure @ dev(mix)
            lams_all = np.concatenate([theta2, np.full(take_q - len(theta2), np.inf)])
            usable = np.concatenate([np.ones(len(theta2), bool),
                                     np.zeros(take_q - len(theta2), bool)])
        n_fetch = min(take_q, k + 12)
        pure = pure[:, :n_fetch].double().cpu().numpy()
        rec["rayleigh_ritz_s"] = time.perf_counter() - t_stage
        t_stage = time.perf_counter()
        # Residual-based acceptance with progressive M-orthogonalization, a
        # little past k so clusters straddling the cut are caught.
        new_found = 0
        rq_pos: list = []   # Rayleigh quotients of M-normalizable candidates
        for i in range(n_fetch):
            if not usable[i]:
                continue
            if len(accepted) >= k:
                kth = np.sort(np.array(accepted_lams))[k - 1]
                if lams_all[i] > kth * (1 + 1e-9) + 1e-12:
                    continue
            c = pure[:, i]
            for u, mu in zip(accepted, accepted_m):
                c = c - (mu @ c) * u
            sx = s64 @ c
            mx = m64 @ c
            mnorm = np.sqrt(abs(c @ mx))
            if mnorm < 1e-8:
                continue
            lam = (c @ sx) / (c @ mx)
            if np.isfinite(lam) and lam > 50 * sigma_eff:
                rq_pos.append(float(lam))
            num = max(np.linalg.norm(sx - lam * mx) - res_floor * np.linalg.norm(c), 0.0)
            res_rel = num / (np.linalg.norm(sx) + abs(lam) * np.linalg.norm(mx) + 1e-300)
            # 1e-4 while the restart budget lasts, 1e-3 in its last quarter.
            thresh = 1e-4 if restart < (3 * max_restarts) // 4 else 1e-3
            if res_rel < thresh:
                accepted_lams.append(lam)
                accepted.append(c / mnorm)
                accepted_m.append(mx / mnorm)
                new_found += 1
            elif res_rel < 1e-1 and (near_miss is None or lam < near_miss_lam):
                near_miss, near_miss_lam = c / mnorm, lam
        rec.update(accept_s=time.perf_counter() - t_stage, new_found=new_found)
        restarts.append(rec)
        if len(accepted) >= k and new_found == 0:
            kth = np.sort(np.array(accepted_lams))[k - 1]
            if near_miss is None or near_miss_lam > kth * (1 - 1e-6):
                break
            # a missed copy below the k-th: the next restart seeds from it
        if len(accepted) >= k:
            kth = np.sort(np.array(accepted_lams))[k - 1]
            if restart >= 1 and new_found and min(accepted_lams[-new_found:]) > kth * (1 + 1e-6):
                break
        # Shift escalation: on a surface with harmonic fields a tiny sigma
        # spreads op over lam_1/sigma decades and nothing past the kernel
        # converges; once the low end is visible, raise sigma to 0.1 of the
        # smallest positive eigenvalue seen and refactor.
        finite_pos = rq_pos + [float(v) for v in accepted_lams if v > 50 * sigma_eff]
        if (len(accepted) < k and finite_pos and sigma_bumps < 3
                and sigma_eff < 0.02 * min(finite_pos)):
            sigma_eff = 0.1 * min(finite_pos)
            sigma_bumps += 1
            stagnant = 0
            sig = torch.tensor(sigma_eff, dtype=dtype, device=device)
            adiag = s_diag + sig * _mass_diag(basis, mass_blocks)
            if host_stepped:
                pack = new_pack()
            continue
        # A pending near-miss seed is progress, even with nothing accepted.
        stagnant = stagnant + 1 if (new_found == 0 and near_miss is None) else 0
        if stagnant >= 2:
            break

    if stats is not None:
        stats.update(sigma_escalations=sigma_bumps, final_sigma=sigma_eff,
                     restart_count=len(restarts), seconds=time.perf_counter() - t_call)
    if len(accepted) < k:
        raise RuntimeError(
            f"only {len(accepted)} of {k} eigenpairs converged "
            f"(accepted: {np.sort(np.array(accepted_lams))}); increase max_lanczos")
    order = np.argsort(np.array(accepted_lams))[:k]
    lams = np.array(accepted_lams)[order]
    coeffs = np.stack(accepted)[order]
    fields = _prolong_multi(basis, dev(coeffs.T)).cpu().numpy()
    return SpectrumResult(lams, coeffs, fields)
