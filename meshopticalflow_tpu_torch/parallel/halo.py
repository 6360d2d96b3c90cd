"""Halo-exchange sharded SpMV and the flow solvers built on it.

Port of meshopticalflow_tpu/parallel/halo.py on torch.distributed, one
process per device. Mesh operators are local: after reverse-Cuthill-McKee
ordering every column that row r references lies within the semiband s of
r. The RCM-ordered rows are cut into contiguous blocks of ceil(n / world)
rows, one per rank, so every reference across ranks falls into a halo of
max(s, 1) rows at each block boundary. A product then exchanges only the
2 * halo boundary values of each rank with its two neighbours (one
``dist.batch_isend_irecv``, the reference's ``lax.ppermute`` pairs, wrap
included) and runs the hand SpMV kernel (kernels/spmv.py::spmv_ell) on
this rank's rows as a rectangular operator: (block, W) against
x_ext = [left halo, own rows, right halo] of block + 2 * halo values.

At world size 1 the neighbour pairs are (0 -> 0): the halos are copies on
the device, and no process group is needed.

Usage::

    h = build_halo_ell(cols, vals, group)     # host prep, static per pattern
    y = h.matvec(x)                           # original row order in/out
    x, stats = halo_pcg(h, b, tol=1e-7)       # Jacobi-PCG on the halo matvec

The permutation in and out of RCM order is paid once per solve, not per
product; the solves run on this rank's rows in permuted order. Their dot
products are summed over the ranks with ``dist.all_reduce``. Scalars stay
on the device inside a chunk; a chunk ends with one host read of ||r||^2.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from meshopticalflow_tpu_torch.kernels.spmv import check_columns, spmv_ell
from meshopticalflow_tpu_torch.parallel.distributed import DeviceGroup
from meshopticalflow_tpu_torch.solvers.banded import (BandedCholeskySolver,
                                                      band_solve_panels,
                                                      build_band_pattern)
from meshopticalflow_tpu_torch.solvers.cg import CGStats, _inv_diag, _safe_div
from meshopticalflow_tpu_torch.utils import spans

_NP_TO_TORCH = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


@dataclasses.dataclass
class HaloEll:
    """Static halo-exchange layout of one padded-ELL pattern on a group,
    this rank's part of it."""

    group: DeviceGroup
    perm: torch.Tensor         # (n,) RCM new -> old (replicated)
    inv_perm: torch.Tensor     # (n,) old -> new (replicated)
    cols_local: torch.Tensor   # (block, W) int32: this rank's rows, halo-local
    vals_p: torch.Tensor       # (block, W) this rank's rows' values
    diag_p: torch.Tensor       # (block,) their diagonal
    n: int                     # true dimension
    block: int                 # rows per rank
    halo: int                  # halo rows per side

    @property
    def n_pad(self) -> int:
        return self.block * self.group.world_size

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x with x, y (replicated) in ORIGINAL row order."""
        return self._from_p(self.matvec_p(self._to_p(x)))

    def _to_p(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of x in permuted order (zero past n)."""
        xp = x[self.perm]
        pad = self.n_pad - self.n
        if pad:
            xp = torch.cat([xp, torch.zeros(pad, dtype=x.dtype, device=x.device)])
        r = self.group.rank
        return xp[r * self.block:(r + 1) * self.block].contiguous()

    def _from_p(self, xp: torch.Tensor) -> torch.Tensor:
        """Every rank's rows gathered, back in original order."""
        return self.group.all_gather_rows(xp)[: self.n][self.inv_perm]

    def matvec_p(self, xp: torch.Tensor) -> torch.Tensor:
        """y = A x on this rank's rows, in permuted order."""
        return _halo_matvec(self.group, self.halo, self.cols_local, self.vals_p, xp)

    @property
    def bytes_exchanged(self) -> int:
        """Bytes one product sends from this rank (both halos)."""
        if self.group.world_size == 1:
            return 0
        return 2 * self.halo * self.vals_p.element_size()


def _peer(group: DeviceGroup, r: int) -> int:
    return dist.get_global_rank(group.group, r) if group.group is not None else r


def _exchange(group: DeviceGroup, x_l: torch.Tensor, halo: int):
    """(left halo, right halo) of this rank: my right edge becomes my right
    neighbour's left halo (the forward pairs i -> i + 1) and my left edge my
    left neighbour's right halo (the backward pairs i -> i - 1), both with
    wrap-around. The wrapped values on the outermost ranks are never
    referenced: no row couples across the band ends."""
    w = group.world_size
    if w == 1:
        return x_l[-halo:], x_l[:halo]
    nxt, prv = _peer(group, (group.rank + 1) % w), _peer(group, (group.rank - 1) % w)
    left = torch.empty(halo, dtype=x_l.dtype, device=x_l.device)
    right = torch.empty_like(left)
    ops = [dist.P2POp(dist.isend, x_l[-halo:].contiguous(), nxt, group.group, tag=0),
           dist.P2POp(dist.isend, x_l[:halo].contiguous(), prv, group.group, tag=1),
           dist.P2POp(dist.irecv, left, prv, group.group, tag=0),
           dist.P2POp(dist.irecv, right, nxt, group.group, tag=1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return left, right


def _halo_matvec(group: DeviceGroup, halo: int, cols_local, vals_p, xp):
    left, right = _exchange(group, xp, halo)
    return spmv_ell(cols_local, vals_p, torch.cat([left, xp, right]))


def build_halo_ell(cols: np.ndarray, vals, group: DeviceGroup,
                   diag: Optional[np.ndarray] = None,
                   perm: Optional[np.ndarray] = None) -> HaloEll:
    """Host prep: RCM-order the pattern, partition the rows contiguously
    over the group, and rewrite the column indices into halo-local
    coordinates (the reference's build_halo_ell, :100-162). Keeps this
    rank's rows on ``group.device``.

    Requires the RCM semiband to fit in one block (s <= rows per rank);
    raises otherwise. The reference's clip of the local columns (:94), which
    guards the ELL pad slots, is applied here once, so the kernel's bound
    check (``check_columns``) holds."""
    import scipy.sparse as sp

    cols = np.asarray(cols)
    n, w = cols.shape
    n_dev = group.world_size
    if perm is None:
        rows = np.repeat(np.arange(n, dtype=np.int64), w)
        pattern = sp.csr_matrix(
            (np.ones(n * w, np.float32), (rows, cols.astype(np.int64).ravel())),
            shape=(n, n))
        perm = np.asarray(sp.csgraph.reverse_cuthill_mckee(
            pattern, symmetric_mode=True), np.int64)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)

    block = -(-n // n_dev)
    # Halo sizing wants the semiband; pad rows (self-referencing, value 0)
    # keep every block full.
    cols_p = inv[cols[perm]]                      # (n, w) permuted space
    semiband = int(np.max(np.abs(cols_p - np.arange(n)[:, None]))) if n else 0
    if semiband > block:
        raise ValueError(
            f"RCM semiband {semiband} exceeds rows-per-device {block}; "
            "use the all-gather path")
    halo = max(semiband, 1)   # >= 1 so the edge slices are never 0-width
    n_pad = block * n_dev
    if isinstance(vals, torch.Tensor):
        dtype = vals.dtype
        vals = vals.detach().cpu().numpy()
    else:
        dtype = _NP_TO_TORCH[np.asarray(vals).dtype]
    vals_h = np.asarray(vals, np.float64)[perm]
    if n_pad > n:
        pad_rows = np.arange(n, n_pad)
        cols_p = np.concatenate([cols_p, np.repeat(pad_rows[:, None], w, 1)])
        vals_h = np.concatenate([vals_h, np.zeros((n_pad - n, w))])
    row_block = np.arange(n_pad)[:, None] // block
    cols_local = np.clip(cols_p - (row_block * block - halo), 0, block + 2 * halo - 1)

    if diag is None:
        match = cols_p == np.arange(n_pad)[:, None]
        diag_p = (vals_h * match).sum(axis=1)
    else:
        diag_p = np.concatenate([np.asarray(diag, np.float64)[perm],
                                 np.zeros(n_pad - n)])

    own = slice(group.rank * block, (group.rank + 1) * block)
    cols_own = np.ascontiguousarray(cols_local[own], np.int32)
    check_columns(cols_own, block + 2 * halo)
    dev = group.device
    return HaloEll(
        group=group,
        perm=torch.as_tensor(perm).to(dev),
        inv_perm=torch.as_tensor(inv).to(dev),
        cols_local=torch.as_tensor(cols_own).to(dev),
        vals_p=torch.as_tensor(np.ascontiguousarray(vals_h[own])).to(dev, dtype),
        diag_p=torch.as_tensor(np.ascontiguousarray(diag_p[own])).to(dev, dtype),
        n=n, block=block, halo=halo)


@dataclasses.dataclass
class HaloCoarse:
    """Replicated exact coarse correction for ``halo_mg_pcg``: the
    production solver's two-level algorithm (nu-step damped-Jacobi
    smoothing around an exact banded-Cholesky coarse solve) on the halo
    layout. The fine rows are split; the coarse space is replicated: each
    rank scatters its restriction partial sums into the n1-vector, one
    ``dist.all_reduce`` sums them, every rank runs the same banded solve
    (solvers/banded.py, float32 factor) on that sum, and prolongation
    gathers from the replicated result. Since every rank's solve reads the
    one all-reduced vector, every rank's z1 is the same, bit for bit."""

    p0_idx_p: torch.Tensor    # (block, K0) c1 column per permuted fine row (this rank's)
    p0_wt_p: torch.Tensor     # (block, K0) weights (0 on pad rows)
    solver: BandedCholeskySolver
    n1: int


def _permute_pad_p0(h: HaloEll, p0_idx, p0_wt):
    """RCM-permute the prolongation gather into the halo row order,
    zero-pad to the split row count, and keep this rank's rows."""
    perm = h.perm.cpu().numpy()
    idx_p = np.asarray(p0_idx)[perm]
    wt_p = np.asarray(p0_wt)[perm]
    if h.n_pad > h.n:
        k0 = idx_p.shape[1]
        idx_p = np.concatenate([idx_p, np.zeros((h.n_pad - h.n, k0), np.int64)])
        wt_p = np.concatenate([wt_p, np.zeros((h.n_pad - h.n, k0), wt_p.dtype)])
    own = slice(h.group.rank * h.block, (h.group.rank + 1) * h.block)
    dev = h.group.device
    return (torch.as_tensor(np.ascontiguousarray(idx_p[own], np.int64)).to(dev),
            torch.as_tensor(np.ascontiguousarray(wt_p[own])).to(dev, h.vals_p.dtype))


def build_halo_coarse(h: HaloEll, p0_idx: np.ndarray, p0_wt, c1_cols: np.ndarray,
                      c1_vals) -> HaloCoarse:
    """Permute the prolongation gather into the halo row order and factor
    the c1 system (banded Cholesky, float32 factor, panelized solves)."""
    idx_p, wt_p = _permute_pad_p0(h, p0_idx, p0_wt)
    solver = BandedCholeskySolver(build_band_pattern(np.asarray(c1_cols)), h.group.device)
    solver.factor(torch.as_tensor(np.asarray(c1_vals)).to(h.group.device, torch.float32))
    return HaloCoarse(p0_idx_p=idx_p, p0_wt_p=wt_p, solver=solver, n1=solver.pat.n)


def _dot(group: DeviceGroup, u, v):
    return group.all_reduce(torch.dot(u, v))


def _halo_cycle(h: HaloEll, hc: HaloCoarse, inv_d, r, omega: float, nu: int):
    """Symmetric two-level V-cycle on the halo layout (the reference's
    _halo_cycle, :222-245)."""
    mv = h.matvec_p
    z = omega * inv_d * r
    for _ in range(nu - 1):
        z = z + omega * inv_d * (r - mv(z))
    res = r - mv(z)
    r1 = torch.zeros(hc.n1, dtype=res.dtype, device=res.device).index_add_(
        0, hc.p0_idx_p.reshape(-1), (hc.p0_wt_p * res[:, None]).reshape(-1))
    h.group.all_reduce(r1)
    s = hc.solver
    z1 = band_solve_panels(s.dinv, s.pbelow, s.perm, s.inv_perm, r1, hc.n1).to(res.dtype)
    z = z + torch.sum(hc.p0_wt_p * z1[hc.p0_idx_p], dim=1)
    for _ in range(nu):
        z = z + omega * inv_d * (r - mv(z))
    return z


def _halo_pcg(h: HaloEll, precondition, b: torch.Tensor, tol: float, max_iters: int,
              chunk: int, x0=None, b_norm2=None):
    """PCG over the halo matvec with ``precondition`` (this rank's rows to
    this rank's rows), ``chunk`` iterations between host reads of ||r||^2;
    b and the result replicated, in ORIGINAL row order."""
    g = h.group
    bp = h._to_p(b)
    b2 = float(b_norm2) if b_norm2 is not None else float(_dot(g, bp, bp))
    if b2 == 0:
        return torch.zeros_like(b), CGStats(0, 0.0)
    if x0 is not None:
        x = h._to_p(x0.to(bp.dtype))
        r = bp - h.matvec_p(x)
    else:
        x = torch.zeros_like(bp)
        r = bp
    p = precondition(r)
    rz = _dot(g, r, p)
    threshold = (tol ** 2) * b2
    done, r2 = 0, b2
    while done < max_iters and r2 > threshold:
        iters = min(chunk, max_iters - done)
        for _ in range(iters):
            ap = h.matvec_p(p)
            alpha = _safe_div(rz, _dot(g, p, ap))
            x = x + alpha * p
            r = r - alpha * ap
            z = precondition(r)
            rz_new = _dot(g, r, z)
            p = z + _safe_div(rz_new, rz) * p
            rz = rz_new
        r2 = float(_dot(g, r, r))
        done += iters
    rel = math.sqrt(max(r2, 0.0) / b2)
    return h._from_p(x).to(b.dtype), CGStats(done, rel)


def halo_mg_pcg(h: HaloEll, hc: HaloCoarse, b: torch.Tensor, tol: float = 1e-7,
                max_iters: int = 2000, chunk: int = 32, omega: float = 0.7, nu: int = 2,
                x0=None, b_norm2=None):
    """PCG over the halo matvec preconditioned by the production two-level
    cycle (damped-Jacobi smoothing + exact banded c1 solve). b and the
    result are replicated, in ORIGINAL row order; iterations come in
    multiples of ``chunk``, as in the reference. ``b_norm2``, when the
    caller already knows ||b||^2 (refinement does), skips one read."""
    inv_d = _inv_diag(h.diag_p)
    return _halo_pcg(h, lambda r: _halo_cycle(h, hc, inv_d, r, omega, nu), b, tol,
                     max_iters, chunk, x0, b_norm2)


def halo_pcg(h: HaloEll, b: torch.Tensor, tol: float = 1e-7, max_iters: int = 2000,
             chunk: int = 128):
    """Jacobi-preconditioned CG on the halo-exchange matvec; b and the
    result are replicated, in ORIGINAL row order. The dot products are
    summed over the ranks; the products exchange only halos."""
    inv_d = _inv_diag(h.diag_p)
    return _halo_pcg(h, lambda r: inv_d * r, b, tol, max_iters, chunk)


class HaloFlowSolver:
    """The flow-solve adapter for ``flow_backend="halo"`` under a group: the
    ``solve`` signature of the single-device multigrid solvers, so
    models/base.py::update_optical_flow wraps it in the same refinement.
    ``gb_per_iter`` is what one iteration streams on this rank (the local
    fine operator 2 * nu + 1 times, the c1 solve panels twice);
    ``factor_seconds`` the c1 factorization's wall time."""

    def __init__(self, h: HaloEll, hc: HaloCoarse, omega: float = 0.7, nu: int = 2,
                 factor_seconds: float = 0.0):
        self.h, self.hc, self.omega, self.nu = h, hc, omega, nu
        self.factor_seconds = factor_seconds

    @property
    def gb_per_iter(self) -> float:
        h, s = self.h, self.hc.solver
        fine = h.cols_local.numel() * 4 + h.vals_p.numel() * h.vals_p.element_size()
        panels = sum(t.numel() * t.element_size() for t in (s.dinv, s.pbelow))
        return ((2 * self.nu + 1) * fine + 2 * panels) / 1e9

    def solve(self, b, tol: float = 1e-7, max_iters: int = 200, x0=None, b_norm2=None):
        return halo_mg_pcg(self.h, self.hc, b, tol=tol, max_iters=max_iters,
                           omega=self.omega, nu=self.nu, x0=x0, b_norm2=b_norm2)


# Static halo layout cache keyed by the fine ELL cols tensor (weakref-guarded
# against id recycling, bounded): the RCM order, the halo-local column
# rewrite, the permuted prolongation gather and the c1 band pattern are per
# problem; only the values change per Gauss-Newton level.
_FLOW_HALO_CACHE: dict = {}


def flow_halo_solver(group: DeviceGroup, cols: torch.Tensor, sys_vals: torch.Tensor,
                     diag: torch.Tensor, c1_cols: torch.Tensor, c1_vals: torch.Tensor,
                     p0_idx: np.ndarray, p0_wt: np.ndarray, nu: int = 2) -> HaloFlowSolver:
    """Build (or revalue) the halo-sharded two-level flow solver for one
    Gauss-Newton level."""
    key = id(cols)
    ent = _FLOW_HALO_CACHE.get(key)
    if ent is None or ent["ref"]() is not cols or ent["group"] != group:
        h = build_halo_ell(cols.cpu().numpy(), sys_vals, group,
                           diag=diag.detach().cpu().numpy())
        pat1 = build_band_pattern(c1_cols.cpu().numpy())
        idx_p, wt_p = _permute_pad_p0(h, p0_idx, p0_wt)
        ent = {"ref": weakref.ref(cols), "group": group, "h": h, "pat1": pat1,
               "p0_idx_p": idx_p, "p0_wt_p": wt_p}
        _FLOW_HALO_CACHE[key] = ent
        if len(_FLOW_HALO_CACHE) > 4:
            _FLOW_HALO_CACHE.pop(next(iter(_FLOW_HALO_CACHE)))
    else:
        ent["h"] = _revalue_halo(ent["h"], sys_vals, diag)
    with spans.timed("halo.c1_factor", sync=group.device) as factor:
        solver1 = BandedCholeskySolver(ent["pat1"], group.device).factor(c1_vals)
    hc = HaloCoarse(p0_idx_p=ent["p0_idx_p"], p0_wt_p=ent["p0_wt_p"], solver=solver1,
                    n1=solver1.pat.n)
    return HaloFlowSolver(ent["h"], hc, nu=nu, factor_seconds=factor.seconds)


def _revalue_halo(h: HaloEll, vals: torch.Tensor, diag: torch.Tensor) -> HaloEll:
    """New level values on the cached static halo layout."""
    own = h.perm[h.group.rank * h.block:(h.group.rank + 1) * h.block]
    n_own = int(min(max(h.n - h.group.rank * h.block, 0), h.block))
    vals_p = torch.zeros((h.block, vals.shape[1]), dtype=vals.dtype, device=vals.device)
    diag_p = torch.zeros(h.block, dtype=diag.dtype, device=diag.device)
    vals_p[:n_own] = vals[own[:n_own]]
    diag_p[:n_own] = diag[own[:n_own]]
    return dataclasses.replace(h, vals_p=vals_p, diag_p=diag_p)
