"""End-to-end surface optical-flow pipeline (the OpticalFlow app's engine).

Port of meshopticalflow_tpu/flow/pipeline.py:
  * init (WhitneyFlowViewer::Init, OpticalFlow.cpp:679-917): load inputs,
    subdivide, build the intrinsic mesh and chart-transition tables, bake
    textures to vertex signals, rasterize the texel sample table, exp-remap
    off-triangle texels, build the vector-field basis (Whitney, Conformal or
    Connection) and, when the mesh was subdivided and ``use_multigrid`` (the
    default), the geometric hierarchy (``attach_coarse_space``), then
    preprocess the comparison signals (log space / DoG band, through the
    hierarchy when there is one);
  * per-level UpdateFlow (OpticalFlow.cpp:423-474): smooth -> advect +-1/2
    -> data term -> regularized Gauss-Newton step. With the hierarchy the
    smoothing and the flow solve are multigrid PCGs, the flow solve inside
    adaptive float64 refinement: the Hopper-kernel cycle of solvers/mg.py
    (``flow_backend`` "auto" or "pallas"), the three-level cycle of
    solvers/mg3.py ("xla"), or, without a patch level (the Conformal and
    Connection bases; the flow solve with ``flow_mg_levels`` 2), the
    two-level cycle of solvers/twolevel.py; with ``flow_backend`` "mf" the
    flow solve is the multifrontal direct solve of solvers/multifrontal.py
    (symbolic analysis once per problem, a numeric factorization per level)
    inside the same refinement, the smoothing the three-level cycle; with
    ``flow_backend`` "halo" under a ``DeviceGroup`` the flow solve is the
    halo-exchange two-level cycle of parallel/halo.py (the fine rows split
    over the group's ranks), the smoothing the three-level cycle. Without
    the hierarchy, Jacobi-PCG (inside float64 iterative refinement
    for the flow); ``use_host_cholesky`` solves each flow system on the host;
  * IterativeOptimization (OpticalFlow.cpp:1035-1056): coarse-to-fine weight
    schedule, then the final advection of both inputs to the halfway point
    and their blend.

Everything that runs per level or per texel runs on ``FlowProblem.device``;
the host does the mesh preprocessing and reads back a few scalars per level.
Under a ``device_group`` (parallel/distributed.py, one process per device)
every rank runs the same host init and level loop on its own device, and
only rank 0 writes files. With the "xla" backend (every backend but "halo"
and "mf" becomes "xla" under a group) on the three-level cycles, or
without a hierarchy, the problem is placed as the reference's
``_place_on_mesh`` places it (parallel/sharding.py::place_problem): each
rank keeps its row block of the smoothing operators and the signals (V
rows) and of the flow basis operator (n_coeffs rows) wherever the count
divides the world size, and the smoothing solve, the DoG preprocessing
solve and the flow solve work on those rows (every product gathers x,
every dot product and norm is reduced over the ranks; the unrefined
smoothing cycle takes its dots over gathered rows); the level trace, the
coarse levels, ``coeffs`` and ``tfield`` stay replicated. With "halo"
the flow solve is the halo-exchange cycle of parallel/halo.py and the rest
is replicated. The final texel marches are split over the ranks
(parallel/sharding.py::advect_texture_sharded).
With ``artifact_cache`` the per-mesh init work is served from the disk
artifact cache (utils/artifacts.py) and the device state from the process
device cache (utils/devcache.py), as the reference package serves them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import hashlib
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from meshopticalflow_tpu_torch import native
from meshopticalflow_tpu_torch.config import FlowConfig, VectorFieldMode, require_supported
from meshopticalflow_tpu_torch.flow.signal import (
    SmoothingOperators, _dog_renormalize, _smooth_system, dog_band, log_space,
    make_smoothing_operators, smooth_signal)
from meshopticalflow_tpu_torch.geometry.mesh import HostMesh, build_mesh
from meshopticalflow_tpu_torch.geometry.rasterize import TextureSource, rasterize_texture_source
from meshopticalflow_tpu_torch.geometry.subdivide import subdivide_tracked
from meshopticalflow_tpu_torch.io.ply import read_triangle_mesh, write_ply_colored
from meshopticalflow_tpu_torch.io.png import read_png_rgb, write_png_rgb
from meshopticalflow_tpu_torch.kernels import bake as bake_kernel
from meshopticalflow_tpu_torch.kernels.advect import (
    _fetch_colors, build_quad_table, flow_field_trace_compacted, resample_signal,
    sample_vertex_signal, vertex_mean)
from meshopticalflow_tpu_torch.kernels.tracing import TraceMesh, exp_map, make_trace_mesh
from meshopticalflow_tpu_torch.models.base import (
    BasisDevice, BasisHost, build_basis, device_block, update_optical_flow)
from meshopticalflow_tpu_torch.models.coarse import (
    CoarseSpace, PatchLevel, VertexCoarse, VertexPatchLevel, build_coarse_space,
    build_patch_level, build_vertex_coarse, build_vertex_patch_level_from)
from meshopticalflow_tpu_torch.parallel.sharding import Rows, place_problem
from meshopticalflow_tpu_torch.solvers.cg import CGStats
from meshopticalflow_tpu_torch.solvers.mg import (
    BandedBreakdownError, MG3MultiSolver, build_c1_band, build_mg_pack)
from meshopticalflow_tpu_torch.solvers.mg3 import ThreeLevelSolver
from meshopticalflow_tpu_torch.solvers.twolevel import (
    TwoLevelSolver, build_transfer, padded_to_csr)
from meshopticalflow_tpu_torch.ops.dataterm import data_term_blocks
from meshopticalflow_tpu_torch.ops.ell import ell_matvec
from meshopticalflow_tpu_torch.utils import devcache, spans
from meshopticalflow_tpu_torch.utils.artifacts import cached, file_hash, key_of


@dataclasses.dataclass
class ProblemArrays:
    """All static device tensors of a flow problem. ``vrows`` / ``frows``:
    the rows of the V-row tensors (smoothing operators, signals) and of the
    flow basis operator that this rank holds (all of them unless
    parallel/sharding.py::place_problem split them over a device group)."""

    tm: TraceMesh
    smooth_ops: SmoothingOperators
    basis: BasisDevice
    signals: Optional[torch.Tensor]  # (V, 2C) both comparison signals channel-stacked
    area: torch.Tensor       # (T,)
    vrows: Optional[Rows] = None
    frows: Optional[Rows] = None

    def __post_init__(self):
        if self.vrows is None:
            self.vrows = Rows(self.smooth_ops.cols.shape[0])
        if self.frows is None:
            self.frows = Rows(self.basis.n_coeffs)


@dataclasses.dataclass
class Hierarchy:
    """The geometric multigrid hierarchy of a subdivided problem: the flow
    coarse space and patch level, and the vertex (smoothing) ones. The patch
    levels exist for the Whitney basis only (None otherwise). ``flow_kind``
    and ``smooth_kind`` name the solvers the levels run: "mg3"
    (solvers/mg.py), "xla" (solvers/mg3.py) or "twolevel"."""

    coarse: CoarseSpace
    patch: Optional[PatchLevel]
    vcoarse: VertexCoarse
    vpatch: Optional[VertexPatchLevel]
    flow_kind: str
    smooth_kind: str


def solver_kinds(config: FlowConfig, has_patch: bool) -> Tuple[str, str]:
    """(flow, smoothing) solver of a hierarchy, as the reference picks them
    (flow/pipeline.py:87-123, 279-311, 423; models/base.py:384-450): the
    flow solve sees the patch level only with ``flow_mg_levels`` >= 3. The
    Hopper-kernel cycle stands in for the reference's Pallas cycle, which
    it runs for ``flow_backend`` "auto" and "pallas" only: under "xla",
    "mf" and "halo" (whose resolved backends are never "pallas",
    kernels/pallas_spmv.py:59-73) both solves take the three-level cycle,
    the flow one as the direct solve's fallback under "mf"; under "halo" a
    DeviceGroup replaces the flow one by the halo-exchange cycle."""
    def kind(patch: bool) -> str:
        if not patch:
            return "twolevel"
        return "xla" if config.flow_backend in ("xla", "mf", "halo") else "mg3"

    return kind(has_patch and config.flow_mg_levels >= 3), kind(has_patch)


@dataclasses.dataclass
class FlowResult:
    coeffs: np.ndarray
    tfield: np.ndarray            # (T, 2) final flow field
    metrics: List[Dict]           # per-level metrics


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "float64": torch.float64}[name]


def resolve_device(device) -> torch.device:
    """The device a problem runs on. A CUDA device without a usable GPU
    raises: the port never falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but "
                               "torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (use cpu or cuda)")
    return dev


def _sync(device: torch.device) -> None:
    """Wait for the device so host clocks attribute time to the right stage."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


# ----------------------------------------------------------------------------
# Device stages
# ----------------------------------------------------------------------------

def _preprocess_signals(smooth_ops: SmoothingOperators, raw: torch.Tensor,
                        config: FlowConfig, hier: Optional[Hierarchy] = None,
                        rows: Optional[Rows] = None) -> torch.Tensor:
    """Comparison-signal construction (OpticalFlow.cpp:820-857).

    raw: (2, V, 3) -> (V, 2C) channel-stacked preprocessed signals. With the
    hierarchy the DoG screened-Poisson solve is the multigrid one (the
    dogSmooth=1e-4 system is stiffness-dominated: Jacobi-PCG needs thousands
    of iterations, multigrid tens). Under a split ``rows`` the operators
    are this rank's rows: the DoG solve works on them and the band is
    gathered once; the result holds every row."""
    sig = raw
    rows = rows or Rows(raw.shape[1])
    if config.log_space:
        sig = log_space(sig)
    if config.dog_weight > 0:
        stacked = torch.cat([sig[0], sig[1]], dim=1)                  # (V, 6)
        if hier is not None:
            solver, b = _vertex_solver(smooth_ops, stacked, hier, config.dog_smooth,
                                       rows)
            smoothed, _ = solver.solve(b, x0=rows.local(stacked), tol=config.cg_tol,
                                       max_iters=min(config.cg_max_iters, 400))
            bands = _dog_renormalize(smooth_ops, stacked, smoothed, rows)
        else:
            bands = dog_band(smooth_ops, stacked, config.dog_smooth,
                             tol=config.cg_tol, max_iters=config.cg_max_iters, rows=rows)
        bands = rows.full(bands)
        if config.channels == 6:
            w = config.dog_weight
            out0 = torch.cat([sig[0] * (1 - w), bands[:, :3] * w], dim=1)
            out1 = torch.cat([sig[1] * (1 - w), bands[:, 3:] * w], dim=1)
            return torch.cat([out0, out1], dim=1)
        return bands
    return torch.cat([sig[0], sig[1]], dim=1)


def _coarse_smooth_system(m0_vals, k0_vals, s_weight, diag_slot):
    """Coarse smoothing system M0 + w K0 and its diagonal."""
    c_vals = m0_vals + s_weight * k0_vals
    c_diag = torch.gather(c_vals, 1, diag_slot[:, None])[:, 0]
    return c_vals, c_diag


def _own_schedule(hier: Hierarchy) -> Hierarchy:
    """``hier`` with MG packs of its own whose chunk scheduling starts
    afresh. ``MGPack.rho`` carries contraction estimates from one level's
    solver to the next; a problem that inherited those of an earlier one
    (a device-cached hierarchy) would cut its PCG chunks elsewhere, stop at
    other iteration counts and so compute other numbers than a cold
    construction."""
    def fresh(level):
        if level is None or level.mg_pack is None:
            return level
        return dataclasses.replace(level, mg_pack=dataclasses.replace(level.mg_pack, rho={}))

    return dataclasses.replace(hier, patch=fresh(hier.patch), vcoarse=fresh(hier.vcoarse))


def _dev(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)


def _vertex_patch_system(vp, w):
    """M2 + w K2 of the vertex patch level (the three-level cycle's dense
    coarsest)."""
    return device_block(vp, "m2_dense", w) + w * device_block(vp, "k2_dense", w)


def _vertex_mg_solver(smooth_ops: SmoothingOperators, signals, hier: Hierarchy,
                      s_weight, force_dense: bool = False):
    """Multi-rhs multigrid solver of the vertex smoothing system and its rhs.
    ``force_dense`` builds the dense-patch-coarsest variant, the fallback
    after a BandedBreakdownError."""
    vc, vp = hier.vcoarse, hier.vpatch
    w = torch.as_tensor(s_weight, dtype=signals.dtype, device=signals.device)
    sys_vals, b, diag = _smooth_system(smooth_ops, signals, w)
    slot0 = _diag_slots(vc.cols0)
    c_vals, c_diag = _coarse_smooth_system(vc.m0_vals, vc.k0_vals, w, slot0)
    if force_dense:
        a2 = _vertex_patch_system(vp, w)
        return MG3MultiSolver(vc.mg_pack, sys_vals, diag, c_vals, c_diag, a2), b
    return MG3MultiSolver(vc.mg_pack, sys_vals, diag, c_vals, c_diag, None,
                          c1_band=vc.c1_band), b


def _vertex_solver(smooth_ops: SmoothingOperators, signals, hier: Hierarchy, s_weight,
                   rows: Optional[Rows] = None):
    """Multi-rhs solver of the vertex smoothing system of ``hier.smooth_kind``
    and its rhs; ``signals`` hold every row. Under a split ``rows`` the
    operators are this rank's rows, and so are the rhs and the "xla"
    solver's vectors; its dots run over the gathered rows (solvers/mg3.py:
    the smoothing is not refined)."""
    if hier.smooth_kind == "mg3":
        return _vertex_mg_solver(smooth_ops, signals, hier, s_weight)
    vc, vp = hier.vcoarse, hier.vpatch
    w = torch.as_tensor(s_weight, dtype=signals.dtype, device=signals.device)
    sys_vals, b, diag = _smooth_system(smooth_ops, signals, w)
    c_vals, c_diag = _coarse_smooth_system(vc.m0_vals, vc.k0_vals, w,
                                           _diag_slots(vc.cols0))
    if hier.smooth_kind == "xla":
        a2 = _vertex_patch_system(vp, w)
        return ThreeLevelSolver(smooth_ops.cols, sys_vals, diag, vc.cols0, c_vals, c_diag,
                                vc.transfer, a2, vp.transfer, rows=rows,
                                gathered_dots=True), b
    return TwoLevelSolver(smooth_ops.cols, sys_vals, diag, vc.cols0, c_vals,
                          vc.transfer), b


def _diag_slots(cols: torch.Tensor) -> torch.Tensor:
    """(n,) slot of each row's diagonal in a square ELL pattern."""
    n = cols.shape[0]
    hit = cols == torch.arange(n, device=cols.device, dtype=cols.dtype)[:, None]
    return torch.argmax(hit.to(torch.int32), dim=1)


def _stage_smooth_mg(arrays: ProblemArrays, config: FlowConfig, solver, b):
    """The multigrid smoothing solve, in two halves past 8 columns (the
    kernel takes at most 8). Returns (smoothed, stats)."""
    kw = dict(tol=config.cg_tol, max_iters=min(config.cg_max_iters, 200))
    if b.shape[1] <= 8:
        return solver.solve(b, x0=arrays.signals, **kw)
    half = (b.shape[1] + 1) // 2
    outs, total_iters, worst = [], 0, 0.0
    for sl in (slice(0, half), slice(half, None)):
        o, st = solver.solve(b[:, sl].contiguous(),
                             x0=arrays.signals[:, sl].contiguous(), **kw)
        outs.append(o)
        total_iters += st.iterations
        worst = max(worst, st.rel_residual)
    return torch.cat(outs, dim=1), CGStats(total_iters, worst)


def _stage_smooth(arrays: ProblemArrays, s_weight, config: FlowConfig,
                  hier: Optional[Hierarchy] = None):
    """Per-level smoothing of the signal columns. Returns (smoothed, stats,
    info) with info the multigrid solver's streamed GB per iteration and
    factor seconds (empty without the hierarchy). Under split vertex rows
    the solve works on this rank's rows, and the smoothed signal is
    gathered once, for the trace: it holds every row."""
    rows = arrays.vrows
    signals = rows.full(arrays.signals)
    if hier is None:
        out, stats = smooth_signal(arrays.smooth_ops, signals, s_weight,
                                   tol=config.cg_tol, max_iters=config.cg_max_iters,
                                   rows=rows)
        return rows.full(out), stats, {}
    if hier.smooth_kind != "mg3":
        solver, b = _vertex_solver(arrays.smooth_ops, signals, hier, s_weight, rows)
        out, stats = solver.solve(b, x0=arrays.signals, tol=config.cg_tol,
                                  max_iters=min(config.cg_max_iters, 200))
        return rows.full(out), stats, dict(gb_per_iter=solver.gb_per_iter,
                                           factor_s=solver.factor_seconds)
    solver, b = _vertex_mg_solver(arrays.smooth_ops, arrays.signals, hier, s_weight)
    try:
        out, stats = _stage_smooth_mg(arrays, config, solver, b)
    except BandedBreakdownError:
        # the deferred c1 check failed at every shift mid-solve: rebuild with
        # the dense-patch coarsest and redo the stage
        solver, b = _vertex_mg_solver(arrays.smooth_ops, arrays.signals, hier,
                                      s_weight, force_dense=True)
        out, stats = _stage_smooth_mg(arrays, config, solver, b)
    return out, stats, dict(gb_per_iter=solver.gb_per_iter,
                            factor_s=solver.factor_seconds)


def _trace_pair(tm: TraceMesh, tfield, dtype, min_step, max_steps):
    """Barycentre lanes advected by -1/2 (first half) and +1/2 (second), in
    one march with cap escalation (the reference package's single-device
    path; on the card one launch of the march_field kernel). Returns (t1,
    p1, exhausted-lane count)."""
    t_count, device = tm.n_triangles, tfield.device
    t0 = torch.arange(t_count, device=device).repeat(2)
    p0 = torch.full((2 * t_count, 2), 1.0 / 3.0, dtype=dtype, device=device)
    times = torch.cat([torch.full((t_count,), -0.5, dtype=dtype, device=device),
                       torch.full((t_count,), 0.5, dtype=dtype, device=device)])
    return flow_field_trace_compacted(tm, tfield, times, t0, p0, min_step, max_steps)


def _advected_vertex_signals(arrays: ProblemArrays, smoothed, t1, p1):
    """Sample both smoothed signals at the advected barycentre end points
    and push the per-triangle values back to vertices by segment mean
    (ResampleSignal, OpticalFlow.cpp:197-260). Returns (V, 2C): [:C] =
    signal 0 advected forward, [C:] = signal 1 advected backward."""
    c = arrays.signals.shape[1] // 2
    t_count = arrays.tm.n_triangles
    sampled = sample_vertex_signal(arrays.tm.triangles, smoothed, t1, p1)
    both = torch.cat([sampled[:t_count, :c], sampled[t_count:, c:]], dim=1)
    return vertex_mean(arrays.tm.triangles, both, smoothed.shape[0])


def _dataterm_from_samples(arrays: ProblemArrays, smoothed, t1, p1):
    """The data term of the advected samples (replicated) and the alignment
    error diff . M diff, its mass product on this rank's vertex rows and
    summed over the ranks."""
    c = arrays.signals.shape[1] // 2
    resampled = _advected_vertex_signals(arrays, smoothed, t1, p1)
    res0, res1 = resampled[:, :c], resampled[:, c:]
    d_blocks, rhs_t = data_term_blocks(arrays.tm.triangles, arrays.area, res0, res1)
    diff = res1 - res0
    mdiff = ell_matvec(arrays.smooth_ops.cols, arrays.smooth_ops.mass_vals, diff)
    align_err = arrays.vrows.dot(arrays.vrows.local(diff), mdiff)
    return d_blocks, rhs_t, align_err


def _stage_resample(arrays: ProblemArrays, tfield, smoothed, config: FlowConfig):
    """Advect both smoothed signals by -1/2 / +1/2 and build the data term
    plus the alignment-error diagnostic (OpticalFlow.cpp:439-470, 1012-1023).
    Returns (d_blocks, rhs_t, align_err, exhausted, (t1, p1))."""
    t1, p1, exhausted = _trace_pair(arrays.tm, tfield, smoothed.dtype,
                                    config.flow_min_step, config.flow_max_steps)
    d_blocks, rhs_t, align_err = _dataterm_from_samples(arrays, smoothed, t1, p1)
    return d_blocks, rhs_t, align_err, exhausted, (t1, p1)


def _level_step(arrays: ProblemArrays, coeffs, tfield, s_weight, v_weight,
                config: FlowConfig, warm_x=None, hier: Optional[Hierarchy] = None,
                on_resampled=None, nd=None, halo_group=None):
    """One UpdateFlow level (OpticalFlow.cpp:423-474): smoothing, advection
    and data term, refined flow solve (multigrid with the hierarchy, the
    multifrontal direct solve with an ``nd`` context, the halo-exchange
    cycle over ``halo_group`` with the hierarchy).
    ``on_resampled`` (when given) receives the advected per-vertex signals
    (V, 2C), the reference's --debug dump (OpticalFlow.cpp:458-465).

    Returns (new_coeffs, new_tfield, metrics, x) with x the solved direction.
    The stage spans synchronize in every run: their seconds are the
    metrics' ``smooth_seconds``, ``trace_seconds`` and ``solve_seconds``."""
    device = coeffs.device
    with spans.timed("level.smooth", sync=device, always_sync=True) as smooth_span:
        smoothed, sm_stats, sm_info = _stage_smooth(arrays, s_weight, config, hier)
    with spans.timed("level.trace", sync=device, always_sync=True) as trace_span:
        d_blocks, rhs_t, align_err, exhausted, (t1, p1) = _stage_resample(
            arrays, tfield, smoothed, config)
        if on_resampled is not None:
            on_resampled(_advected_vertex_signals(arrays, smoothed, t1, p1))
    solve_kw = dict(nd=nd, refine_tol=config.flow_refine_tol,
                    refine_floor=config.flow_refine_floor)
    if hier is not None:
        solve_kw.update(coarse=hier.coarse, patch=hier.patch, mg_kind=hier.flow_kind,
                        halo_group=halo_group,
                        mg_cheb_k=config.mg_cheb_k, mg_coarse_exact=config.mg_coarse_exact,
                        mg_c1_bf16=config.mg_c1_bf16, mg_nu=config.mg_nu,
                        mg_fine_cheb=config.mg_fine_cheb)
    flow = {}
    with spans.timed("level.solve", sync=device, always_sync=True) as solve_span:
        new_coeffs, new_tfield, cg_stats, x = update_optical_flow(
            arrays.basis, coeffs, d_blocks, rhs_t, v_weight,
            cg_tol=config.cg_tol, cg_max_iters=config.cg_max_iters,
            use_host_cholesky=config.use_host_cholesky,
            refine=config.flow_refine, x0=warm_x, solve_info=flow, rows=arrays.frows,
            **solve_kw)
    metrics = dict(
        smooth_iters=float(sm_stats.iterations), smooth_res=float(sm_stats.rel_residual),
        flow_iters=float(cg_stats.iterations), flow_res=float(cg_stats.rel_residual),
        trace_exhausted=float(exhausted),
        smooth_seconds=smooth_span.seconds, trace_seconds=trace_span.seconds,
        solve_seconds=solve_span.seconds,
        alignment_error=float(align_err))
    if flow:
        metrics.update(coarse_factor_s=flow["factor_s"], flow_gb_per_iter=flow["gb_per_iter"])
    if "mf_fallback" in flow:
        metrics["mf_fallback"] = float(flow["mf_fallback"])
    if sm_info:
        metrics.update(smooth_factor_s=sm_info["factor_s"],
                       smooth_gb_per_iter=sm_info["gb_per_iter"])
    return new_coeffs, new_tfield, metrics, x


def _halfway_lanes(src_t_sorted, src_p_sorted, t_back: float, t_fwd: float):
    """Both textures' march lanes: start states and per-lane flow times."""
    t2 = torch.cat([src_t_sorted, src_t_sorted])
    p2 = torch.cat([src_p_sorted, src_p_sorted])
    n = src_t_sorted.shape[0]
    kw = dict(dtype=src_p_sorted.dtype, device=src_p_sorted.device)
    times = torch.cat([torch.full((n,), t_back, **kw), torch.full((n,), t_fwd, **kw)])
    return t2, p2, times


def _halfway_tail(c0, c1, order, src_t, tex0, tex1, h: int, w: int):
    """Scatter the sampled colours back to raster order, fill unclaimed
    texels with the input blend, blend, clip and truncate to uint8."""
    accum_s = c0 + c1
    accum = torch.zeros_like(accum_s).index_copy(0, order, accum_s)
    base = (torch.flip(tex0, [0]) + torch.flip(tex1, [0])).reshape(-1, 3)
    accum = torch.where((src_t >= 0)[:, None], accum, base)
    blend = (accum / 2.0).reshape(h, w, 3)
    return torch.clamp(blend, 0, 255).to(torch.uint8)


# ----------------------------------------------------------------------------
# Host helpers (copies of the reference package's numpy code)
# ----------------------------------------------------------------------------

def _host_sample_texture(texture: np.ndarray, uv: np.ndarray, bilinear: bool) -> np.ndarray:
    """numpy clone of the reference texture fetch (MeshFlow.inl:65-84)."""
    h, w = texture.shape[:2]
    tex = texture.astype(np.float64)
    x = np.clip(uv[:, 0], 0, 1) * (w - 1)
    y = np.clip(1.0 - uv[:, 1], 0, 1) * (h - 1)
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    if not bilinear:
        return tex[y0, x0]
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    dx, dy = (x - x0)[:, None], (y - y0)[:, None]
    return (tex[y0, x0] * (1 - dx) * (1 - dy) + tex[y0, x1] * dx * (1 - dy)
            + tex[y1, x1] * dx * dy + tex[y1, x0] * (1 - dx) * dy)


def sample_texture_to_vertices(triangles: np.ndarray, uvs: np.ndarray,
                               texture: np.ndarray, n_vertices: int,
                               bilinear: bool = True) -> np.ndarray:
    """Per-wedge texture average into vertex colors (MeshFlow.inl:251-266)."""
    samples = _host_sample_texture(texture, uvs.reshape(-1, 2), bilinear)
    colors = np.zeros((n_vertices, 3))
    counts = np.zeros(n_vertices)
    np.add.at(colors, triangles.ravel(), samples)
    np.add.at(counts, triangles.ravel(), 1.0)
    return colors / np.maximum(counts, 1)[:, None]


def _texture_geometry(mesh_path: str, edge_length_fraction: float) -> dict:
    """PLY parse, tracked subdivision and mesh tables of a textured mesh
    (OpticalFlow.cpp:684-752) as one artifact dict, the reference's geom
    artifact (flow/pipeline.py:1087-1108): the fine tris, verts, uvs and
    mesh tables and, when the mesh was subdivided (``subdivided``), the
    root (tris0, verts0) with parent and bary, the multigrid hierarchy's
    input."""
    data = read_triangle_mesh(mesh_path)
    if data.face_uvs is None:
        raise ValueError(f"{mesh_path} has no texture coordinates")
    diag = float(np.linalg.norm(data.vertices.max(0) - data.vertices.min(0)))
    tris, verts, uvs = data.faces, data.vertices, data.face_uvs
    edge_len = edge_length_fraction * diag
    out = dict(tris0=data.faces, verts0=data.vertices, subdivided=np.asarray(edge_len > 0))
    if edge_len > 0:
        tris, verts, uvs, parent, bary = subdivide_tracked(tris, verts, uvs, edge_len)
        out.update(parent=parent, bary=bary)
    mesh = build_mesh(tris, vertices=verts)
    out.update(tris=tris, verts=verts, uvs=uvs, g=mesh.g, g_inv=mesh.g_inv, area=mesh.area,
               opp=mesh.opp, xform_linear=mesh.xform_linear, xform_const=mesh.xform_const,
               n_vertices=np.asarray(mesh.n_vertices))
    return out


class FlowProblem:
    """A prepared optical-flow problem: its device tensors and level loop.

    With ``cache_key`` (the constructors pass the problem's artifact key
    when ``config.artifact_cache`` is on) the host work behind the basis and
    the hierarchy is served from the disk artifact cache (utils/artifacts.py)
    and the device state from the process device cache (utils/devcache.py):
    a second construction of the same problem in one process reuses the
    first one's tensors and computes the same numbers. ``signals_key`` keys
    the textures and the preprocessed signals (inputs' content hashes).

    ``device_group`` (parallel/distributed.py::DeviceGroup) runs the problem
    on this rank's device as one of the group's ranks, the reference's
    ``device_mesh``: "mf" raises (single-device by design), every backend
    but "halo" becomes "xla" (the reference's GSPMD path), the device cache
    is bypassed, and the texel lanes of the final marches are split over
    the ranks. At two or more ranks "xla" on the three-level cycles (or
    without a hierarchy) also splits the level step's rows
    (``_places_rows``; ``arrays.vrows`` / ``arrays.frows``).

    ``job`` (utils/spans.py) is the id that the problem's init, run and
    halfway spans share; the constructors open the ``init`` span around the
    whole set-up and pass theirs, a direct construction takes a fresh one.
    ``init_profile`` holds the seconds of the init spans, read in every run
    (their synchronize only while the span record is on)."""

    def __init__(
        self,
        config: FlowConfig,
        mesh: HostMesh,
        signals: np.ndarray,               # (2, V, 3) raw input signals
        vertices: Optional[np.ndarray] = None,
        texture_source: Optional[TextureSource] = None,
        tri_uvs=None,         # (T, 3, 2) wedge uvs, an array or a tensor
        textures=None,        # (2, H, W, 3) uint8, an array or a tensor
        vertex_colors: Optional[np.ndarray] = None,  # (2, V, 3)
        device="cuda",
        root=None,   # (tris0, verts0, parent, bary): build the MG hierarchy
        cache_key: Optional[str] = None,
        signals_key: Optional[str] = None,
        device_group=None,
        job: Optional[int] = None,
    ):
        require_supported(config)
        if device_group is not None and config.flow_backend == "mf":
            # The multifrontal direct solve is single-device by design:
            # refuse instead of degrading to another solver.
            raise ValueError(
                "flow_backend='mf' is single-device only; use flow_backend='halo' "
                "(halo-exchange MG-PCG) or 'auto' for sharded runs")
        if device_group is not None and config.flow_backend != "halo":
            config = dataclasses.replace(config, flow_backend="xla")
        self.device_group = device_group
        self.config = config
        self.device = device_group.device if device_group is not None \
            else resolve_device(device)
        self.dtype = torch_dtype(config.dtype)
        self.mesh = mesh
        self.vertices = vertices
        self._cache_key = cache_key if config.artifact_cache else None
        self._signals_key = signals_key if config.artifact_cache else None
        self.job = spans.new_job() if job is None else job
        self.init_profile: Dict[str, float] = {}
        kw = dict(dtype=self.dtype, device=self.device)
        step = self._init_step

        with spans.timed("init.tables", sync=self.device):
            with step("init.device_tables", "device_tables"):
                tm, smooth_ops = self._cached(
                    self._devkey("tables"),
                    lambda: (make_trace_mesh(mesh, self.dtype, self.device),
                             make_smoothing_operators(mesh, self.dtype, self.device)))
            with step("init.basis", "basis"):
                self.basis_host, basis = self._build_basis_cached(mesh, config)
            self.hier = None
            if root is not None and config.use_multigrid:
                with step("init.coarse", "coarse"):
                    self.hier = self.attach_coarse_space(basis, smooth_ops, *root)
            arrays = ProblemArrays(tm=tm, smooth_ops=smooth_ops, basis=basis, signals=None,
                                   area=torch.as_tensor(mesh.area).to(**kw))
            if self._places_rows():
                arrays = place_problem(device_group, arrays)
        with step("init.signals", "preprocess_signals"):
            arrays.signals = arrays.vrows.local(
                self._preprocessed_signals(arrays.smooth_ops, signals, arrays.vrows))
        self.arrays = arrays
        self.nd = None
        self._ensure_nd()

        self.texture_source = texture_source
        with step("init.textures", "exp_remap"):
            self.textures = None if textures is None else self._cached(
                self._devkey("textures", self._signals_key) if self._signals_key else None,
                lambda: torch.as_tensor(textures).to(**kw))
            self.tri_uvs = None if tri_uvs is None else torch.as_tensor(tri_uvs).to(**kw)
            self.vertex_colors = None if vertex_colors is None else \
                torch.as_tensor(np.asarray(vertex_colors)).to(**kw)
        self._exp_exhausted = None
        with step("init.texels", "exp_remap"):
            if texture_source is not None:
                # Keyed by the atlas dimensions: a texel count alone can collide
                # across W x H layouts of the same mesh.
                self.src_t, self.src_p, self._exp_exhausted = self._cached(
                    self._devkey("texsrc", config.pad_radius, int(texture_source.width),
                                 int(texture_source.height)),
                    self._texel_table)
        self.coeffs = torch.zeros(basis.n_coeffs, **kw)
        self.tfield = torch.zeros((mesh.n_triangles, 2), **kw)
        self._warm_x = None
        self._advect_order = None
        self._quad_tables = None

    # -- construction ----------------------------------------------------

    @contextlib.contextmanager
    def _init_step(self, name: str, key: str):
        """An init span ``name``, synchronized while the span record is on,
        whose seconds add to ``init_profile[key]``."""
        with spans.timed(name, sync=self.device) as step:
            yield
        self.init_profile[key] = self.init_profile.get(key, 0.0) + step.seconds

    def _places_rows(self) -> bool:
        """Whether the level step's rows are split over the device group:
        two or more ranks, the "xla" backend, and the three-level cycles or
        no hierarchy (the runs the reference shards, tests/test_parallel.py:
        64-110). The halo backend, the two-level cycles and the host solve
        stay replicated."""
        g, hier, cfg = self.device_group, self.hier, self.config
        return (g is not None and g.world_size > 1 and cfg.flow_backend == "xla"
                and not cfg.use_host_cholesky
                and (hier is None or (hier.flow_kind, hier.smooth_kind) == ("xla", "xla")))

    def _devkey(self, *parts):
        """A device-cache key of this problem, None without a cache key."""
        return (self._cache_key, str(self.dtype)) + parts if self._cache_key else None

    def _cached(self, key, build):
        if self.device_group is not None:
            key = None     # placement is per group: no device-state reuse
        return devcache.get_or_build(key, build, self.device)

    def _build_basis_cached(self, mesh: HostMesh, config: FlowConfig):
        """build_basis through the artifact and device caches."""
        if not self._cache_key:
            return build_basis(mesh, config, self.device)
        bk = key_of("basis", self._cache_key, int(config.vf_mode),
                    int(config.connection_mode), config.divergence_free)
        return self._cached(("basis_dev", bk, str(self.dtype)),
                            lambda: self._basis_from_artifact(mesh, bk))

    def _basis_from_artifact(self, mesh: HostMesh, bk: str):
        def compute():
            host, dev = build_basis(mesh, dataclasses.replace(self.config, dtype="float64"))
            return dict(name=np.frombuffer(host.name.encode(), np.uint8),
                        n_coeffs=np.asarray(host.n_coeffs), p_idx=host.p_idx,
                        p_wt=host.p_wt, smooth=host.smooth,
                        ell_cols=_to_numpy(dev.ell_cols), s_vals=_to_numpy(dev.s_vals),
                        diag_slot=_to_numpy(dev.diag_slot), dt_slots=_to_numpy(dev.dt_slots))

        d = cached("basis", bk, compute)
        host = BasisHost(bytes(d["name"]).decode(), int(d["n_coeffs"]), d["p_idx"],
                         d["p_wt"], d["smooth"])
        dev, dt = self.device, self.dtype
        return host, BasisDevice(
            p_idx=_dev(d["p_idx"], torch.int64, dev), p_wt=_dev(d["p_wt"], dt, dev),
            ell_cols=_dev(d["ell_cols"], torch.int32, dev),
            s_vals=_dev(d["s_vals"], dt, dev),
            diag_slot=_dev(d["diag_slot"], torch.int64, dev),
            dt_slots=_dev(d["dt_slots"], torch.int64, dev), n_coeffs=int(d["n_coeffs"]))

    def attach_coarse_space(self, basis: BasisDevice, smooth_ops: SmoothingOperators,
                            tris0, verts0, parent, bary) -> Hierarchy:
        """The two-level geometric coarse spaces from subdivision parent
        tracking (models/coarse.py), one for the flow basis and one for the
        smoothing solves; for the Whitney basis also their patch levels
        (the reference's ``has_patch``, flow/pipeline.py:930, 952-967). Then
        the static operators of the solvers the levels run
        (``solver_kinds``): the padded-ELL MG packs (P0, P0^T built on the
        host) and the RCM band layouts of the exact coarse solve for
        solvers/mg.py, or the working-dtype transfers of solvers/twolevel.py
        and solvers/mg3.py. The host arrays come from the artifact cache and
        the handles from the device cache (the reference's coarse artifact,
        flow/pipeline.py:903-1060); under the exact banded coarse solve the
        dense patch blocks, read only by its fallback, stay unread on the
        host until first use. Each step's seconds go into ``init_profile``."""
        cfg = self.config
        whitney = VectorFieldMode(cfg.vf_mode) == VectorFieldMode.WHITNEY
        flow_kind, smooth_kind = solver_kinds(cfg, whitney)
        defer_dense = bool(cfg.mg_coarse_exact) and flow_kind == smooth_kind == "mg3"
        ck = key_of("coarse", self._cache_key, int(cfg.vf_mode), int(cfg.connection_mode),
                    cfg.divergence_free) if self._cache_key else ""
        hier = self._cached(
            ("coarse_dev", ck, str(self.dtype), defer_dense, bool(cfg.mg_coarse_exact),
             flow_kind, smooth_kind) if ck else None,
            lambda: self._build_hierarchy(basis, smooth_ops, (tris0, verts0, parent, bary),
                                          ck, defer_dense, flow_kind, smooth_kind))
        return _own_schedule(hier)

    def _build_hierarchy(self, basis, smooth_ops, root, ck, defer_dense, flow_kind,
                         smooth_kind) -> Hierarchy:
        cfg, dev, dt = self.config, self.device, self.dtype
        tris0, verts0, parent, bary = root

        def step(key):
            return self._init_step("init." + key, key)

        def compute():
            # float64 host arrays; the handles below cast to the working dtype
            cfg64 = dataclasses.replace(cfg, dtype="float64")
            with step("coarse_space"):
                coarse_mesh = build_mesh(tris0, vertices=verts0)
                cs = build_coarse_space(cfg64, self.mesh, self.basis_host, coarse_mesh,
                                        parent, bary)
            with step("vertex_coarse"):
                vc = build_vertex_coarse(cfg64, self.mesh, coarse_mesh, parent, bary)
            cd = cs.coarse_dev
            out = dict(
                ch_name=np.frombuffer(cs.coarse_host.name.encode(), np.uint8),
                ch_n=np.asarray(cs.coarse_host.n_coeffs), ch_p_idx=cs.coarse_host.p_idx,
                ch_p_wt=cs.coarse_host.p_wt, ch_smooth=cs.coarse_host.smooth,
                cd_ell_cols=_to_numpy(cd.ell_cols), cd_s_vals=_to_numpy(cd.s_vals),
                cd_diag_slot=_to_numpy(cd.diag_slot), cd_dt_slots=_to_numpy(cd.dt_slots),
                p0=cs.p0, p0_idx=cs.p0_idx, p0_wt=cs.p0_wt,
                vc_cols0=_to_numpy(vc.cols0), vc_m0=_to_numpy(vc.m0_vals),
                vc_k0=_to_numpy(vc.k0_vals), vc_p0_idx=_to_numpy(vc.p0_idx),
                vc_p0_wt=_to_numpy(vc.p0_wt), vc_m0_csr=vc.m0_csr, vc_k0_csr=vc.k0_csr,
                has_patch=np.asarray(VectorFieldMode(cfg.vf_mode) == VectorFieldMode.WHITNEY))
            if bool(out["has_patch"]):
                with step("patch_levels"):
                    pl, patch_ids = build_patch_level(cfg64, coarse_mesh, cs)
                    vp = build_vertex_patch_level_from(cfg64, vc.m0_csr, vc.k0_csr,
                                                       coarse_mesh, patch_ids)
                    out.update(q2_idx=_to_numpy(pl.q2_idx), q2_wt=_to_numpy(pl.q2_wt),
                               s2=_to_numpy(pl.s2_dense), p12_idx=pl.p12_idx,
                               p12_wt=pl.p12_wt, vp_m2=_to_numpy(vp.m2_dense),
                               vp_k2=_to_numpy(vp.k2_dense), vp_p12_idx=vp.p12_idx,
                               vp_p12_wt=vp.p12_wt)
            return out

        with step("coarse_load"):
            d = cached("coarse", ck, compute, enabled=bool(ck),
                       lazy_keys=("s2", "vp_m2", "vp_k2") if defer_dense else ())
        with step("coarse_upload"):
            cs = CoarseSpace(
                BasisHost(bytes(d["ch_name"]).decode(), int(d["ch_n"]), d["ch_p_idx"],
                          d["ch_p_wt"], d["ch_smooth"]),
                BasisDevice(p_idx=_dev(d["ch_p_idx"], torch.int64, dev),
                            p_wt=_dev(d["ch_p_wt"], dt, dev),
                            ell_cols=_dev(d["cd_ell_cols"], torch.int32, dev),
                            s_vals=_dev(d["cd_s_vals"], dt, dev),
                            diag_slot=_dev(d["cd_diag_slot"], torch.int64, dev),
                            dt_slots=_dev(d["cd_dt_slots"], torch.int64, dev),
                            n_coeffs=int(d["ch_n"])),
                d["p0"], d["p0_idx"], d["p0_wt"])
            vc = VertexCoarse(cols0=_dev(d["vc_cols0"], torch.int32, dev),
                              m0_vals=_dev(d["vc_m0"], dt, dev),
                              k0_vals=_dev(d["vc_k0"], dt, dev),
                              p0_idx=_dev(d["vc_p0_idx"], torch.int32, dev),
                              p0_wt=_dev(d["vc_p0_wt"], dt, dev),
                              m0_csr=d["vc_m0_csr"], k0_csr=d["vc_k0_csr"])
            patch = vp = None
            if bool(d["has_patch"]):
                # fallback-only blocks stay on the host under the exact c1 solve
                dense = (lambda a: a) if defer_dense else (lambda a: _dev(a, dt, dev))
                patch = PatchLevel(q2_idx=_dev(d["q2_idx"], torch.int64, dev),
                                   q2_wt=_dev(d["q2_wt"], dt, dev), s2_dense=dense(d["s2"]),
                                   p12_idx=d["p12_idx"], p12_wt=d["p12_wt"])
                vp = VertexPatchLevel(m2_dense=dense(d["vp_m2"]),
                                      k2_dense=dense(d["vp_k2"]),
                                      p12_idx=d["vp_p12_idx"], p12_wt=d["vp_p12_wt"])
        if flow_kind == "mg3":
            with step("mg_pack_flow"):
                patch.mg_pack = build_mg_pack(basis.ell_cols, cs.coarse_dev.ell_cols, cs.p0,
                                              patch.p12_idx, patch.p12_wt,
                                              int(patch.s2_dense.shape[0]), dt, dev)
            with step("c1_band_flow"):
                patch.c1_band = build_c1_band(cs.coarse_dev.ell_cols, device=dev)
        else:
            with step("transfer_flow"):
                cs.transfer = build_transfer(cs.p0, dt, dev)
                if flow_kind == "xla":
                    patch.transfer = build_transfer(
                        padded_to_csr(patch.p12_idx, patch.p12_wt, patch.s2_dense.shape[0]),
                        dt, dev)
        p0v = padded_to_csr(vc.p0_idx, vc.p0_wt, vc.cols0.shape[0])
        if smooth_kind == "mg3":
            with step("mg_pack_smooth"):
                vc.mg_pack = build_mg_pack(smooth_ops.cols, vc.cols0, p0v, vp.p12_idx,
                                           vp.p12_wt, int(vp.m2_dense.shape[0]), dt, dev)
            with step("c1_band_smooth"):
                vc.c1_band = build_c1_band(vc.cols0, device=dev)
        else:
            with step("transfer_smooth"):
                vc.transfer = build_transfer(p0v, dt, dev)
                if smooth_kind == "xla":
                    vp.transfer = build_transfer(
                        padded_to_csr(vp.p12_idx, vp.p12_wt, vp.m2_dense.shape[0]), dt, dev)
        return Hierarchy(coarse=cs, patch=patch, vcoarse=vc, vpatch=vp,
                         flow_kind=flow_kind, smooth_kind=smooth_kind)

    def _preprocessed_signals(self, smooth_ops: SmoothingOperators, signals,
                              rows: Rows) -> torch.Tensor:
        """``_preprocess_signals`` of the raw (2, V, 3) signals on the
        operators of ``rows``, every row of the result, through the
        artifact and device caches when the problem has a signals key and
        the DoG band (an iterative solve) is on: the key pins everything
        that shapes the result, the device type and a row split included
        (the reference's flow/pipeline.py:807-835)."""
        cfg, kw = self.config, dict(dtype=self.dtype, device=self.device)

        def compute():
            raw = torch.as_tensor(np.asarray(signals)).to(**kw)
            return _preprocess_signals(smooth_ops, raw, cfg, self.hier, rows)

        if not (self._signals_key and cfg.dog_weight > 0):
            return compute()
        hier = self.hier
        split = ("rows", rows.group.world_size) if rows.split else ()
        key = key_of("sigpre", self._signals_key, cfg.dog_weight, cfg.dog_smooth,
                     cfg.log_space, cfg.channels, cfg.dtype, cfg.cg_tol, cfg.cg_max_iters,
                     cfg.flow_backend, cfg.nearest, self.device.type, hier is not None,
                     hier is not None and hier.vpatch is not None, *split)
        return self._cached(
            ("sig_dev", key, str(self.dtype)),
            lambda: torch.as_tensor(cached(
                "sigpre", key, lambda: dict(sig=_to_numpy(compute())))["sig"]).to(**kw))

    def _texel_table(self):
        """The texel table on the device, exp-remapped: (src_t, src_p, the
        remap's exhausted-lane count)."""
        src = self.texture_source
        self.src_t = torch.as_tensor(src.tri_idx).to(device=self.device, dtype=torch.int64)
        self.src_p = torch.as_tensor(src.bary).to(device=self.device, dtype=self.dtype)
        self._exp_remap_texels()
        return self.src_t, self.src_p, self._exp_exhausted

    def _ensure_nd(self):
        """The multifrontal direct-solve context, once per problem
        (``flow_backend="mf"``; the reference's flow/pipeline.py:767-796):
        the nested-dissection symbolic analysis on the level-invariant flow
        pattern (artifact-cached) and one upload of the per-depth index
        tables (device-cached). It needs the vertex embedding for the
        inertial bisection; a problem without vertices runs the multigrid
        solve (or Jacobi-PCG) instead. Its seconds are ``init_profile``'s
        ``nd_pack``."""
        if self.nd is not None:
            return self.nd
        if self.config.flow_backend != "mf" or self.vertices is None:
            return None
        from meshopticalflow_tpu_torch.solvers.multifrontal import build_nd_context

        cfg, basis = self.config, self.arrays.basis
        ck = key_of("ndpack", self._cache_key, int(cfg.vf_mode), int(cfg.connection_mode),
                    cfg.divergence_free, 64) if self._cache_key else ""
        with self._init_step("init.nd_pack", "nd_pack"):
            self.nd = self._cached(
                ("nd_dev", ck) if ck else None,
                lambda: build_nd_context(self.mesh.triangles, self.vertices,
                                         self.basis_host.p_idx, basis.ell_cols,
                                         basis.n_coeffs, diag_slot=basis.diag_slot, leaf=64,
                                         cache_key=ck, device=self.device))
        return self.nd

    @classmethod
    def from_texture_inputs(cls, mesh_path: str, texture_paths: Tuple[str, str],
                            config: FlowConfig, device="cuda",
                            device_group=None) -> "FlowProblem":
        """Texture-pair alignment setup (WhitneyFlowViewer::Init texture
        branch, OpticalFlow.cpp:684-752 + 818). With ``config.artifact_cache``
        the geometry (PLY parse, subdivision, mesh tables) and the baked
        signals come from the artifact cache and the rasterized texel table
        from the device cache (the reference's flow/pipeline.py:1072-1160).
        ``init_profile["raster_path"]`` says which rasterizer built the
        table: "native" (native/meshhost.cpp) or "numpy"."""
        use_cache = config.artifact_cache
        job = spans.new_job()
        with spans.job(job), spans.span("init"):
            with spans.timed("init.geometry") as geom:
                mesh_hash = file_hash(mesh_path)
                geo_key = key_of("geom", mesh_hash, config.subdivide_edge_length)
                gd = devcache.get_or_build(
                    ("geom_host", geo_key) if use_cache else None,
                    lambda: cached("geom", geo_key,
                                   lambda: _texture_geometry(mesh_path,
                                                             config.subdivide_edge_length),
                                   enabled=use_cache),
                    "host")
                tris, verts, uvs = gd["tris"], gd["verts"], gd["uvs"]
                mesh = HostMesh(triangles=np.asarray(tris, np.int32), g=gd["g"],
                                g_inv=gd["g_inv"], area=gd["area"],
                                opp=np.asarray(gd["opp"], np.int32),
                                xform_linear=gd["xform_linear"],
                                xform_const=gd["xform_const"],
                                n_vertices=int(gd["n_vertices"]))
                root = (gd["tris0"], gd["verts0"], gd["parent"], gd["bary"]) \
                    if bool(gd["subdivided"]) else None
            with spans.timed("init.decode") as decode:
                tex0 = read_png_rgb(texture_paths[0])
                tex1 = read_png_rgb(texture_paths[1])
            if tex0.shape != tex1.shape:
                raise ValueError(f"texture shapes differ: {tex0.shape} vs {tex1.shape}")
            n_vertices = int(tris.max()) + 1
            dev = device_group.device if device_group is not None else resolve_device(device)
            with spans.timed("init.bake") as bake:
                tex_hashes = (file_hash(texture_paths[0]), file_hash(texture_paths[1]))
                # the pair's textures and wedge uvs go up once: the bake reads
                # them, and the problem casts its textures and tri_uvs from them
                tex_dev = torch.from_numpy(np.stack([tex0, tex1])).to(dev)
                uvs_dev = torch.from_numpy(np.ascontiguousarray(uvs, np.float64)).to(dev)

                def baked():
                    wedges, offsets = devcache.get_or_build(
                        ("bake_table", geo_key) if use_cache else None,
                        lambda: bake_kernel.wedge_table(tris, n_vertices, dev), dev)
                    return dict(signals=bake_kernel.bake_vertices(
                        tex_dev, uvs_dev, wedges, offsets, not config.nearest).cpu().numpy())

                signals = cached("bake", key_of("bake", geo_key, *tex_hashes, config.nearest),
                                 baked, enabled=use_cache)["signals"]
            h, w = tex0.shape[:2]

            def raster():
                path = "native" if native.get_lib() is not None else "numpy"
                return rasterize_texture_source(uvs, w, h, config.pad_radius), path

            with spans.timed("init.raster") as rast:
                src, raster_path = devcache.get_or_build(
                    ("texsrc_host", geo_key, w, h, config.pad_radius) if use_cache else None,
                    raster, "host")
            problem = cls(config, mesh, signals, vertices=verts, texture_source=src,
                          tri_uvs=uvs_dev, textures=tex_dev, device=device,
                          root=root, cache_key=geo_key,
                          signals_key=key_of("sig", geo_key, *tex_hashes),
                          device_group=device_group, job=job)
        problem.init_profile.update(geom=geom.seconds, decode=decode.seconds,
                                    bake=bake.seconds, raster=rast.seconds,
                                    raster_path=raster_path)
        return problem

    @classmethod
    def from_vertex_inputs(cls, path0: str, path1: str, config: FlowConfig,
                           device="cuda", device_group=None) -> "FlowProblem":
        """Colored-PLY-pair setup (OpticalFlow.cpp:753-780): identical
        connectivity required; geometry is the average of the two. With
        ``config.artifact_cache`` the problem is keyed by the content of its
        triangles and vertices, so the pairs of a sequence over one mesh
        (apps/track_sequence.py) share the mesh tables, basis and
        multifrontal pack."""
        job = spans.new_job()
        with spans.job(job), spans.span("init"):
            with spans.timed("init.decode") as decode:
                m0 = read_triangle_mesh(path0)
                m1 = read_triangle_mesh(path1)
            if m0.vertices.shape != m1.vertices.shape:
                raise ValueError("vertex counts differ")
            if not np.array_equal(m0.faces, m1.faces):
                raise ValueError("triangle indices do not match")
            if m0.colors is None or m1.colors is None:
                raise ValueError("inputs must carry per-vertex colors")
            verts = (m0.vertices + m1.vertices) * 0.5
            key = None
            if config.artifact_cache:
                digest = hashlib.sha1(np.ascontiguousarray(m0.faces, np.int64).tobytes())
                digest.update(np.ascontiguousarray(verts, np.float64).tobytes())
                key = key_of("vmesh", digest.hexdigest()[:16])
            with spans.timed("init.geometry") as geom:
                mesh = devcache.get_or_build(("vmesh_host", key) if key else None,
                                             lambda: build_mesh(m0.faces, vertices=verts),
                                             "host")
            problem = cls(config, mesh, np.stack([m0.colors, m1.colors]), vertices=verts,
                          vertex_colors=np.stack([m0.colors, m1.colors]), device=device,
                          cache_key=key, device_group=device_group, job=job)
        problem.init_profile.update(geom=geom.seconds, decode=decode.seconds)
        return problem

    def _exp_remap_texels(self) -> None:
        """Push out-of-triangle texels through the geodesic exp
        (RemapSamplePoint, MeshFlow.inl:339-350), out of place: the table
        may be shared through the device cache."""
        mask = self.texture_source.needs_remap
        if not mask.any():
            return
        idx = torch.as_tensor(np.nonzero(mask)[0]).to(self.device)
        t_in = self.src_t[idx]
        p_in = self.src_p[idx]
        center = torch.full_like(p_in, 1.0 / 3.0)
        t1, p1, exhausted = exp_map(self.arrays.tm, t_in, center, p_in - center,
                                    with_diagnostics=True)
        self.src_t = self.src_t.index_copy(0, idx, t1)
        self.src_p = self.src_p.index_copy(0, idx, p1)
        self._exp_exhausted = exhausted

    # -- outer loop (IterativeOptimization, OpticalFlow.cpp:1035-1056) ---

    def run(self, verbose: bool = False, checkpoint_dir: Optional[str] = None,
            resume: bool = True, debug_dir: Optional[str] = None) -> FlowResult:
        """Coarse-to-fine optimization; optionally checkpoints each level to
        ``checkpoint_dir`` and resumes from the latest checkpoint there.

        ``debug_dir`` writes the per-level advected signals as colored PLYs
        ``resampled.{S,T}.<level>.ply``, the reference's --debug dumps
        (OpticalFlow.cpp:458-465). Under a device group only rank 0 writes
        checkpoints and dumps; every rank reads a checkpoint to resume. The
        run is a span ``run`` of the problem's job, a level a span ``level``."""
        with spans.job(self.job), spans.span("run"):
            return self._run(verbose, checkpoint_dir, resume, debug_dir)

    def _run(self, verbose: bool, checkpoint_dir: Optional[str], resume: bool,
             debug_dir: Optional[str]) -> FlowResult:
        cfg = self.config
        writer = self._is_writer()
        halo_group = self.device_group if cfg.flow_backend == "halo" else None
        coeffs, tfield = self.coeffs, self.tfield
        s_weight = cfg.scalar_smooth_weight
        v_weight = cfg.resolved_vf_smooth_weight()
        start_level = 0
        if checkpoint_dir:
            os.makedirs(checkpoint_dir, exist_ok=True)
            if resume:
                ckpts = sorted(glob.glob(os.path.join(checkpoint_dir, "level_*.npz")))
                if ckpts:
                    lvl, s_weight, v_weight = self.load_checkpoint(ckpts[-1])
                    coeffs, tfield = self.coeffs, self.tfield
                    start_level = lvl + 1
        metrics: List[Dict] = []
        warm_x = self._warm_x if cfg.flow_warm_start else None
        self._warm_x = None
        for level in range(start_level, cfg.levels):
            t0 = time.time()
            dump = None if debug_dir is None or not writer else (
                lambda res, level=level: self._write_debug_dumps(debug_dir, level,
                                                                 _to_numpy(res)))
            with spans.span("level"):
                coeffs, tfield, stats, x = _level_step(
                    self.arrays, coeffs, tfield, s_weight, v_weight, cfg, warm_x=warm_x,
                    hier=self.hier, on_resampled=dump, nd=self._ensure_nd(),
                    halo_group=halo_group)
            if cfg.flow_warm_start:
                warm_x = x
            if level == start_level and self._exp_exhausted is not None:
                stats["exp_remap_exhausted"] = float(self._exp_exhausted)
                self._exp_exhausted = None
            stats.update(level=level, s_weight=s_weight, v_weight=v_weight,
                         seconds=time.time() - t0)
            if stats.get("exp_remap_exhausted", 0):
                print(f"[WARNING] exp remap: {int(stats['exp_remap_exhausted'])} "
                      f"texel lanes hit the step cap", file=sys.stderr)
            if stats["trace_exhausted"] > 0:
                # The reference warns per-lane on cap exhaustion (FEM.inl:897).
                print(f"[WARNING] level {level}: "
                      f"{int(stats['trace_exhausted'])} trace lanes hit the "
                      f"step cap mid-path", file=sys.stderr)
            metrics.append(stats)
            if verbose:
                print(json.dumps({k: (float(f"{v:.6g}") if isinstance(v, float) else v)
                                  for k, v in stats.items()}))
            s_weight *= cfg.scalar_weight_multiplier
            if v_weight * cfg.vf_weight_multiplier > cfg.vf_smooth_weight_threshold:
                v_weight = v_weight * cfg.vf_weight_multiplier
            if checkpoint_dir and writer:
                self.coeffs, self.tfield = coeffs, tfield
                self.save_checkpoint(
                    os.path.join(checkpoint_dir, f"level_{level:03d}.npz"),
                    level, s_weight, v_weight, warm_x=warm_x)
        self.coeffs, self.tfield = coeffs, tfield
        return FlowResult(_to_numpy(coeffs), _to_numpy(tfield), metrics)

    def _is_writer(self) -> bool:
        """Whether this process writes files: always without a device group,
        rank 0 under one."""
        return self.device_group is None or self.device_group.rank == 0

    def _write_debug_dumps(self, debug_dir: str, level: int,
                           resampled: np.ndarray) -> None:
        """Per-level resampled.{S,T}.<level>.ply dumps (--debug). 6-channel
        signals blend as c[j] + c[j+3] (OutputMesh, OpticalFlow.cpp:150-162);
        binary little-endian, as the reference package writes them."""
        os.makedirs(debug_dir, exist_ok=True)
        c = resampled.shape[1] // 2
        verts = self.vertices if self.vertices is not None else \
            np.zeros((resampled.shape[0], 3))
        for s, tag in ((0, "S"), (1, "T")):
            sig = resampled[:, s * c:(s + 1) * c]
            colors = sig if c == 3 else sig[:, :3] + sig[:, 3:6]
            write_ply_colored(os.path.join(debug_dir, f"resampled.{tag}.{level}.ply"),
                              verts, colors, self.mesh.triangles, fmt="binary_le")

    # -- final outputs ---------------------------------------------------

    def advected_vertex_colors(self, alpha: float = 0.5) -> np.ndarray:
        """Advect the original input colors to the halfway point
        (InputGeometryData::flow, OpticalFlow.cpp:476-490). Returns (2, V, 3)."""
        cfg = self.config
        outs = []
        for s in range(2):
            length = -alpha if s == 0 else 1.0 - alpha
            outs.append(_to_numpy(resample_signal(
                self.arrays.tm, self.tfield, self.vertex_colors[s], length,
                cfg.flow_min_step, cfg.flow_max_steps)))
        return np.stack(outs)

    def advected_textures(self, alpha: float = 0.5) -> np.ndarray:
        """Advect both textures to the halfway point (InputTextureData::flow,
        OpticalFlow.cpp:501-515), one compacted march each. Returns (2, H, W,
        3) float in uv-space row order; unclaimed texels keep the input."""
        h, w = self.texture_source.height, self.texture_source.width
        return np.stack([_to_numpy(self._advect_one_texture(s, alpha)).reshape(h, w, 3)
                         for s in range(2)])

    def _advect_one_texture(self, s: int, alpha: float) -> torch.Tensor:
        """Texture ``s`` advected to the halfway point: (H*W, 3) float on the
        device, raster order, unclaimed texels keeping the input."""
        from meshopticalflow_tpu_torch.kernels.advect import advect_texture_compacted

        cfg = self.config
        self._ensure_advect_order()
        length = -alpha if s == 0 else 1.0 - alpha
        quad = self._ensure_quad_tables()[s] if not cfg.nearest else None
        if self.device_group is not None:
            from meshopticalflow_tpu_torch.parallel.sharding import advect_texture_sharded

            colors_s, exhausted = advect_texture_sharded(
                self.device_group, self.arrays.tm, self.tfield, self.tri_uvs,
                self.textures[s], self._advect_src_t, self._advect_src_p, length,
                cfg.flow_min_step, cfg.flow_max_steps, not cfg.nearest, quad=quad)
        else:
            colors_s, _, _, exhausted = advect_texture_compacted(
                self.arrays.tm, self.tfield, self.tri_uvs, self.textures[s],
                self._advect_src_t, self._advect_src_p, length, cfg.flow_min_step,
                cfg.flow_max_steps, not cfg.nearest, quad=quad)
        if exhausted:
            print(f"[WARNING] texture advection: {exhausted} texel lanes "
                  f"hit the step cap", file=sys.stderr)
        colors = torch.zeros_like(colors_s).index_copy(0, self._advect_order, colors_s)
        base = torch.flip(self.textures[s], [0]).reshape(-1, 3)
        return torch.where((self.src_t >= 0)[:, None], colors, base)

    def advected_texture_frames(self, frames: int) -> np.ndarray:
        """N-frame texture interpolation (InputTextureData::flow frames
        overload, OpticalFlow.cpp:517-539): the texel table flowed on by
        -+1/(frames-1) per frame, sampling the original textures each frame.
        Returns (2, frames, H, W, 3) float64 in uv-space row order."""
        from meshopticalflow_tpu_torch.kernels.advect import advect_texture_frames_scan

        cfg = self.config
        h, w = self.texture_source.height, self.texture_source.width
        alpha = 1.0 / (frames - 1)
        outs = np.empty((2, frames, h, w, 3), np.float64)
        for s in range(2):
            base_flat = torch.flip(self.textures[s], [0]).reshape(-1, 3)
            outs[s, 0] = _to_numpy(base_flat).reshape(h, w, 3)
            quad = self._ensure_quad_tables()[s] if not cfg.nearest else None
            colors = advect_texture_frames_scan(
                self.arrays.tm, self.tfield, self.tri_uvs, self.textures[s], self.src_t,
                self.src_p, -alpha if s == 0 else alpha, frames, cfg.flow_min_step,
                cfg.flow_max_steps, not cfg.nearest, quad=quad)
            colors = torch.where((self.src_t >= 0)[None, :, None], colors, base_flat[None])
            outs[s, 1:] = _to_numpy(colors).reshape(frames - 1, h, w, 3)
        return outs

    def _ensure_advect_order(self) -> None:
        """March lanes sorted by starting triangle, so neighbouring lanes
        read neighbouring table rows; outputs scatter back to raster order."""
        if self._advect_order is None:
            order = torch.argsort(self.src_t, stable=True)
            self._advect_order = order
            self._advect_src_t = self.src_t[order]
            self._advect_src_p = self.src_p[order]

    def _ensure_quad_tables(self):
        if self._quad_tables is None:
            self._quad_tables = tuple(build_quad_table(self.textures[s])
                                      for s in range(2))
        return self._quad_tables

    def halfway_texture(self, alpha: float = 0.5) -> np.ndarray:
        """(H, W, 3) uint8 halfway blend (the --out result), blended and
        quantized on the device (OutputImage, OpticalFlow.cpp:1044-1047).

        Both textures' lanes march in one compacted trace, with per-lane
        flow times -alpha and 1-alpha; under a device group each texture's
        lanes are split over the ranks (``advect_texture_sharded``), which
        gives every lane the same end point.

        The call is a span ``halfway`` of the problem's job, timed on the
        device too, around ``halfway.march`` (under a group the march and
        the fetch), ``halfway.fetch``, ``halfway.tail`` (scatter, fill,
        blend, quantize) and ``halfway.copy`` (the blend to the host); the
        counters ``halfway.exhausted_lanes``, ``halfway.copies`` and
        ``halfway.copy_bytes`` add up every call's."""
        cfg = self.config
        src = self.texture_source
        h, w = src.height, src.width
        cuda = self.device.type == "cuda"
        with spans.job(self.job), spans.span("halfway", device=cuda):
            self._ensure_advect_order()
            quads = self._ensure_quad_tables() if not cfg.nearest else (None, None)
            if self.device_group is not None:
                from meshopticalflow_tpu_torch.parallel.sharding import advect_texture_sharded

                with spans.span("halfway.march", device=cuda):
                    (c0, e0), (c1, e1) = (advect_texture_sharded(
                        self.device_group, self.arrays.tm, self.tfield, self.tri_uvs,
                        self.textures[s], self._advect_src_t, self._advect_src_p, length,
                        cfg.flow_min_step, cfg.flow_max_steps, not cfg.nearest,
                        quad=quads[s])
                        for s, length in ((0, -alpha), (1, 1.0 - alpha)))
                exhausted = e0 + e1
            else:
                n = self._advect_src_t.shape[0]
                with spans.span("halfway.march", device=cuda):
                    t2, p2, times = _halfway_lanes(self._advect_src_t, self._advect_src_p,
                                                   -alpha, 1.0 - alpha)
                    t1, p1, exhausted = flow_field_trace_compacted(
                        self.arrays.tm, self.tfield, times, t2, p2,
                        cfg.flow_min_step, cfg.flow_max_steps)
                with spans.span("halfway.fetch", device=cuda):
                    c0 = _fetch_colors(self.tri_uvs, self.textures[0], t1[:n], p1[:n],
                                       not cfg.nearest, quad=quads[0])
                    c1 = _fetch_colors(self.tri_uvs, self.textures[1], t1[n:], p1[n:],
                                       not cfg.nearest, quad=quads[1])
            spans.count("halfway.exhausted_lanes", int(exhausted))
            if exhausted:
                print(f"[WARNING] texture advection: {exhausted} texel lanes "
                      f"hit the step cap", file=sys.stderr)
            with spans.span("halfway.tail", device=cuda):
                q = _halfway_tail(c0, c1, self._advect_order, self.src_t,
                                  self.textures[0], self.textures[1], h, w)
            with spans.span("halfway.copy", device=cuda):
                result = _to_numpy(q)
            spans.count("halfway.copies")
            spans.count("halfway.copy_bytes", q.numel() * q.element_size())
        return result

    def save_checkpoint(self, path: str, level: int, s_weight: float,
                        v_weight: float, warm_x=None) -> None:
        """Mid-run checkpoint of the optimization state, in the reference
        package's format (its checkpoints load here and the other way round)."""
        extra = {} if warm_x is None else {"warm_x": _to_numpy(warm_x)}
        np.savez(path, coeffs=_to_numpy(self.coeffs), tfield=_to_numpy(self.tfield),
                 level=level, s_weight=s_weight, v_weight=v_weight, **extra)

    def load_checkpoint(self, path: str):
        kw = dict(dtype=self.dtype, device=self.device)
        with np.load(path) as data:
            self.coeffs = torch.as_tensor(data["coeffs"]).to(**kw)
            self.tfield = torch.as_tensor(data["tfield"]).to(**kw)
            self._warm_x = (torch.as_tensor(data["warm_x"]).to(**kw)
                            if "warm_x" in data else None)
            return int(data["level"]), float(data["s_weight"]), float(data["v_weight"])

    def write_output(self, path: str, alpha: float = 0.5) -> None:
        """Blend the two advected inputs and write (OpticalFlow.cpp:1044-1055).
        Under a device group every rank computes the blend, rank 0 writes."""
        if self.texture_source is not None:
            blend = self.halfway_texture(alpha)
            if self._is_writer():
                write_png_rgb(path, np.flipud(blend))  # flipY (OpticalFlow.cpp:1047)
        else:
            adv = self.advected_vertex_colors(alpha)
            blend = (adv[0] + adv[1]) / 2.0
            if self._is_writer():
                write_ply_colored(path, self.vertices, blend, self.mesh.triangles,
                                  fmt="ascii")
