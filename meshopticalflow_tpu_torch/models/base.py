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

Under a device group whose ranks split the flow basis operator by rows
(parallel/sharding.py::place_problem) the level step takes ``rows``
(ops/rows.py's ``Rows``): ``ell_cols``, ``s_vals`` and
``diag_slot`` hold this rank's rows, the data term is assembled whole from
the replicated blocks and then cut to those rows, the solve works on them,
and the step's dot products are summed over the ranks. The coarse levels,
``coeffs`` and ``tfield`` are replicated.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from meshopticalflow_tpu_torch.config import ConnectionMode, FlowConfig, VectorFieldMode
from meshopticalflow_tpu_torch.geometry.mesh import HostMesh
from meshopticalflow_tpu_torch.ops.ell import coo_slot_map, ell_from_scipy, ell_matvec
from meshopticalflow_tpu_torch.ops.rows import Rows


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
    """Factory over the three basis families (OpticalFlow.cpp:862-870)."""
    from meshopticalflow_tpu_torch.models.conformal import build_conformal_basis
    from meshopticalflow_tpu_torch.models.connection import build_connection_basis
    from meshopticalflow_tpu_torch.models.whitney import build_whitney_basis

    mode = VectorFieldMode(config.vf_mode)
    if mode == VectorFieldMode.WHITNEY:
        host = build_whitney_basis(mesh)
    elif mode == VectorFieldMode.CONFORMAL:
        host = build_conformal_basis(mesh, divergence_free=config.divergence_free)
    else:
        host = build_connection_basis(mesh, ConnectionMode(config.connection_mode))
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
    flat = torch.zeros(basis.n_coeffs * basis.ell_width, dtype=vals.dtype,
                       device=vals.device)
    return flat.index_add_(0, basis.dt_slots, vals.reshape(-1))


def build_flow_system(basis: BasisDevice, d_blocks, rhs_t, vf_smooth_weight, rows=None):
    """Assemble the level system (R D P)/||.||_F + lambda S on the union ELL
    pattern plus the reduced, rescaled rhs (VectorField.h:51-67). Under a
    split ``rows`` the data term and its Frobenius norm come from every row
    (the blocks are replicated), then the system, rhs and diagonal are cut
    to this rank's rows."""
    n, w = basis.n_coeffs, basis.ell_width
    rows = rows or Rows(n)
    dt_flat = data_term_ell_vals(basis, d_blocks)
    frob = torch.sqrt(torch.sum(dt_flat * dt_flat))
    scale = torch.where(frob > 0, 1.0 / frob, torch.zeros_like(frob))
    dt_vals = rows.local((dt_flat * scale).reshape(n, w))
    rhs = rows.local(reduce_rhs(basis, rhs_t) * scale)
    sys_vals = dt_vals + vf_smooth_weight * basis.s_vals
    diag = torch.gather(sys_vals, 1, basis.diag_slot[:, None])[:, 0]
    return sys_vals, dt_vals, rhs, diag, scale


def coarse_system_vals(coarse_dev: BasisDevice, d_blocks, scale, vf_smooth_weight):
    """Galerkin coarse system values and their diagonal: scale * Q^T D Q +
    lambda * S0, the exact P0^T A P0 of the fine system (models/coarse.py)."""
    n, w = coarse_dev.ell_cols.shape
    dt0 = data_term_ell_vals(coarse_dev, d_blocks) * scale
    vals = dt0.reshape(n, w) + vf_smooth_weight * coarse_dev.s_vals
    diag = torch.gather(vals, 1, coarse_dev.diag_slot[:, None])[:, 0]
    return vals, diag


def patch_system_dense(q2_idx, q2_wt, d_blocks, scale, vf_smooth_weight, s2_dense):
    """Dense coarsest Galerkin system: scale * Q2^T D Q2 + lambda * S2."""
    vals = torch.einsum("tak,tab,tbl->tkl", q2_wt, d_blocks, q2_wt)
    n2 = s2_dense.shape[0]
    flat = (q2_idx[:, :, None] * n2 + q2_idx[:, None, :]).reshape(-1)
    dt2 = torch.zeros(n2 * n2, dtype=vals.dtype, device=vals.device) \
        .index_add_(0, flat, vals.reshape(-1)).reshape(n2, n2)
    return dt2 * scale + vf_smooth_weight * s2_dense


def finalize_flow_step(basis: BasisDevice, coeffs, x, dt_vals, rhs, rows=None):
    """Optimal step tau = (x . rhs) / (x . dataTerm x) and coefficient
    update (VectorField.h:89-103). Under a split ``rows`` x, dt_vals and rhs
    are this rank's rows: the dots are summed over the ranks and x is
    gathered before the update and ``prolong``."""
    rows = rows or Rows(basis.n_coeffs)
    x_full = rows.full(x)
    dx = ell_matvec(basis.ell_cols, dt_vals, x_full)
    denom = rows.sum(torch.dot(x, dx))
    num = rows.sum(torch.dot(x, rhs))
    nz = denom != 0
    step = torch.where(nz, num / torch.where(nz, denom, torch.ones_like(denom)),
                       torch.zeros_like(num))
    new_coeffs = coeffs + step * x_full
    return new_coeffs, prolong(basis, new_coeffs)


def device_block(level, name: str, like: torch.Tensor) -> torch.Tensor:
    """A dense patch-level block (``s2_dense``, ``m2_dense``, ``k2_dense``)
    as a tensor of ``like``'s device and dtype. Under the exact banded
    coarse solve the hierarchy keeps these fallback-only blocks on the host,
    possibly as unread npz members (utils/artifacts.LazyNpzArray); the first
    use uploads one and keeps it on ``level``."""
    block = getattr(level, name)
    if not isinstance(block, torch.Tensor):
        block = torch.as_tensor(np.ascontiguousarray(np.asarray(block))).to(
            device=like.device, dtype=like.dtype)
        setattr(level, name, block)
    return block


def _make_mg_solver(basis, coarse, patch, d_blocks, scale, vf_smooth_weight, sys_vals,
                    diag, kind, mg_cheb_k, mg_nu, mg_fine_cheb, mg_coarse_exact,
                    mg_c1_bf16=False, halo_group=None, rows=None):
    """The per-level flow solver on the hierarchy of ``kind`` (the
    reference's models/base.py:366-450; flow/pipeline.py:solver_kinds picks
    it): "mg3", the Hopper-kernel cycle of solvers/mg.py (the exact banded
    c1 cycle, or, without the exact c1 or after its factorization broke down
    at every shift, the 3-level cycle with the dense patch coarsest); "xla",
    the three-level cycle of solvers/mg3.py; "twolevel", the two-level cycle
    of solvers/twolevel.py (no patch level read). With ``halo_group``
    (``flow_backend="halo"`` under a DeviceGroup) it is the halo-exchange
    two-level cycle of parallel/halo.py instead, whatever ``kind``: the
    fine rows split over the group, the exact banded c1 solve replicated.
    A split ``rows`` runs the "xla" cycle on this rank's fine rows; the
    other kinds take the whole operator."""
    c_vals, c_diag = coarse_system_vals(coarse.coarse_dev, d_blocks, scale,
                                        vf_smooth_weight)
    if halo_group is not None:
        from meshopticalflow_tpu_torch.parallel.halo import flow_halo_solver

        return flow_halo_solver(halo_group, basis.ell_cols, sys_vals, diag,
                                coarse.coarse_dev.ell_cols, c_vals, coarse.p0_idx,
                                coarse.p0_wt, nu=mg_nu)
    if kind == "mg3":
        from meshopticalflow_tpu_torch.solvers.mg import MG3Solver

        solver = None
        if mg_coarse_exact:
            # the dense patch coarsest is never touched on this path
            solver = MG3Solver(patch.mg_pack, sys_vals, diag, c_vals, c_diag, None,
                               cheb_k=mg_cheb_k, nu=mg_nu, c1_band=patch.c1_band,
                               cheb_fine_deg=mg_fine_cheb, c1_bf16=mg_c1_bf16)
            if solver.c1_l_blocks is None:
                solver = None
        if solver is None:
            a2 = patch_system_dense(patch.q2_idx, patch.q2_wt, d_blocks, scale,
                                    vf_smooth_weight, device_block(patch, "s2_dense", sys_vals))
            solver = MG3Solver(patch.mg_pack, sys_vals, diag, c_vals, c_diag, a2,
                               cheb_k=mg_cheb_k, nu=mg_nu)
        return solver
    if kind == "xla":
        from meshopticalflow_tpu_torch.solvers.mg3 import ThreeLevelSolver

        a2 = patch_system_dense(patch.q2_idx, patch.q2_wt, d_blocks, scale,
                                vf_smooth_weight, device_block(patch, "s2_dense", sys_vals))
        return ThreeLevelSolver(basis.ell_cols, sys_vals, diag,
                                coarse.coarse_dev.ell_cols, c_vals, c_diag,
                                coarse.transfer, a2, patch.transfer, nu=4, rows=rows)
    from meshopticalflow_tpu_torch.solvers.twolevel import TwoLevelSolver

    return TwoLevelSolver(basis.ell_cols, sys_vals, diag, coarse.coarse_dev.ell_cols,
                          c_vals, coarse.transfer)


def host_direct_solve(cols: torch.Tensor, vals: torch.Tensor,
                      rhs: torch.Tensor) -> torch.Tensor:
    """x = A^{-1} rhs by scipy's sparse direct solve of the float64 system on
    the host, the reference's correctness oracle (models/base.py:499-511)."""
    import scipy.sparse.linalg as spla

    n, w = cols.shape
    mat = sp.csc_matrix((vals.detach().to("cpu", torch.float64).numpy().ravel(),
                         (np.repeat(np.arange(n), w), cols.cpu().numpy().ravel())),
                        shape=(n, n))
    x = spla.spsolve(mat, rhs.detach().to("cpu", torch.float64).numpy())
    return torch.as_tensor(x).to(device=rhs.device, dtype=rhs.dtype)


def update_optical_flow(
    basis: BasisDevice,
    coeffs: torch.Tensor,
    d_blocks: torch.Tensor,     # (T, 2, 2)
    rhs_t: torch.Tensor,        # (T, 2)
    vf_smooth_weight,
    cg_tol: float = 1e-7,
    cg_max_iters: int = 2000,
    cg_chunk: int = 128,
    use_host_cholesky: bool = False,
    refine: bool = True,
    x0: Optional[torch.Tensor] = None,
    coarse=None,       # models.coarse.CoarseSpace: the geometric hierarchy
    patch=None,        # models.coarse.PatchLevel (the 3-level cycles)
    mg_kind: str = "mg3",    # the hierarchy's flow solver (_make_mg_solver)
    mg_cheb_k: int = 1,
    mg_coarse_exact: bool = False,
    mg_c1_bf16: bool = False,
    mg_nu: int = 2,
    mg_fine_cheb: int = 0,
    refine_tol: float = 3e-9,
    refine_floor: float = 1e-5,
    solve_info: Optional[dict] = None,
    nd=None,           # solvers.multifrontal.NDContext: the direct per-level
                       # solve (flow_backend="mf"); MG is its fallback
    halo_group=None,   # parallel.distributed.DeviceGroup: the halo-exchange
                       # two-level solve (flow_backend="halo" under a group)
    rows=None,         # ops.rows.Rows: this rank's rows of the basis
                       # operator when they are split over a device group
):
    """One Gauss-Newton flow step (VectorField::UpdateOpticalFlow,
    VectorField.h:46-104): system assembly, the solve, step finalize.

    ``use_host_cholesky`` solves on the host (``host_direct_solve``, zero
    iterations). With an ``nd`` context the solve is the multifrontal
    direct solve (solvers/multifrontal.py) inside the refinement loop, one
    triangular-sweep pair a round (the reference's non-df32 path,
    models/base.py:557-565); when its relative residual misses
    max(100 * refine_tol, 1e-7) (a float32 factor that broke down, or an
    accuracy miss), the level is refactored under a 1e-6 relative diagonal
    shift, and if that misses too, handed to the multigrid solver
    (models/base.py:608-626). With the hierarchy (``coarse``) alone the
    solve is a multigrid PCG (``_make_mg_solver``; the halo-exchange cycle
    of parallel/halo.py with a ``halo_group``) inside the adaptive
    refinement loop, with the inner call the reference makes
    (models/base.py:606-611); without either, Jacobi-PCG inside refinement
    when ``refine``. Both fill ``solve_info`` (when given) with the solver's
    streamed GB per iteration and its factorization seconds; under ``nd``
    also ``mf_fallback``: 0 the direct solve, 1 the shifted refactor, 2 the
    multigrid solver.

    Under a split ``rows`` (the "xla" cycle or Jacobi-PCG; the basis
    operator of this rank's rows) the system is this rank's rows, the
    solvers take ``rows``, and x0 and the returned x hold every row.

    Returns (new_coeffs, tfield, solve_stats, x) where x is the solved
    direction (the next level's warm start when that is enabled)."""
    from meshopticalflow_tpu_torch.solvers.cg import CGStats, ell_pcg
    from meshopticalflow_tpu_torch.solvers.refine import ell_solve_refined, refine_loop

    vf_smooth_weight = torch.as_tensor(vf_smooth_weight, dtype=coeffs.dtype,
                                       device=coeffs.device)
    rows = rows or Rows(basis.n_coeffs)
    sys_vals, dt_vals, rhs, diag, scale = build_flow_system(basis, d_blocks, rhs_t,
                                                            vf_smooth_weight, rows)
    if x0 is not None:
        x0 = rows.local(x0)
    if rows.split:
        if use_host_cholesky or nd is not None or halo_group is not None or (
                coarse is not None and mg_kind != "xla"):
            raise ValueError("split flow rows run the 'xla' cycle or Jacobi-PCG only")
    if use_host_cholesky:
        x = host_direct_solve(basis.ell_cols, sys_vals, rhs)
        stats = CGStats(0, 0.0)
    elif coarse is not None or nd is not None:
        from meshopticalflow_tpu_torch.solvers.mg import BandedBreakdownError

        def build(exact):
            return _make_mg_solver(basis, coarse, patch, d_blocks, scale,
                                   vf_smooth_weight, sys_vals, diag, mg_kind, mg_cheb_k,
                                   mg_nu, mg_fine_cheb, exact, mg_c1_bf16, halo_group,
                                   rows)

        def run(solver):
            if not refine:
                return solver.solve(rhs, x0=x0, tol=cg_tol,
                                    max_iters=min(cg_max_iters, 200))
            return refine_loop(
                basis.ell_cols, sys_vals, rhs,
                lambda r, tol_inner, rn2=None: solver.solve(
                    r, tol=max(cg_tol, tol_inner),
                    max_iters=min(cg_max_iters, 120), b_norm2=rn2),
                tol=refine_tol, inner_floor=refine_floor, x0=x0, rows=rows)

        def run_direct(solver):
            # a warm start is pointless against an exact solve: x0 is ignored
            if not refine:
                return solver.solve(rhs)
            return refine_loop(basis.ell_cols, sys_vals, rhs,
                               lambda r, tol_inner, rn2=None: solver.solve(r),
                               tol=refine_tol, inner_floor=refine_floor)

        def run_mg():
            solver = build(mg_coarse_exact)
            try:
                return solver, run(solver)
            except BandedBreakdownError:
                # the deferred c1 check failed at every shift mid-solve: redo
                # the solve with the dense-patch coarsest
                solver = build(False)
                return solver, run(solver)

        fallback = None
        if nd is not None:
            from meshopticalflow_tpu_torch.solvers.multifrontal import NDSolver

            def missed(stats):
                return not float(stats.rel_residual) <= max(100 * refine_tol, 1e-7)

            solver = NDSolver(nd.pack, nd.levels_dev, sys_vals)
            x, stats = run_direct(solver)
            fallback = 0
            if missed(stats):
                solver = NDSolver(nd.pack, nd.levels_dev, sys_vals,
                                  diag_slot=basis.diag_slot, shift_rel=1e-6)
                x, stats = run_direct(solver)
                fallback = 1
                if missed(stats) and coarse is not None:
                    solver, (x, stats) = run_mg()
                    fallback = 2
        else:
            solver, (x, stats) = run_mg()
        if solve_info is not None:
            solve_info.update(gb_per_iter=solver.gb_per_iter,
                              factor_s=solver.factor_seconds)
            if fallback is not None:
                solve_info["mf_fallback"] = fallback
    elif refine:
        x, stats = ell_solve_refined(basis.ell_cols, sys_vals, diag, rhs,
                                     inner_tol=max(cg_tol, 1e-6),
                                     inner_iters=cg_max_iters, chunk=cg_chunk,
                                     x0=x0, rows=rows)
    else:
        x, stats = ell_pcg(basis.ell_cols, sys_vals, diag, rhs, x0=x0,
                           tol=cg_tol, max_iters=cg_max_iters, chunk=cg_chunk,
                           rows=rows)
    new_coeffs, tfield = finalize_flow_step(basis, coeffs, x, dt_vals, rhs, rows)
    return new_coeffs, tfield, stats, rows.full(x)
