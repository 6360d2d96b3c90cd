"""One UpdateFlow level with fixed solver iteration counts.

Port of meshopticalflow_tpu/flow/fixed.py. The production path
(flow/pipeline.py) stops its solves at a tolerance; this variant runs fixed
iteration counts, so the whole level is one pure function of its tensors:
the unit that parallel/sharding.py::sharded_level_step splits over a
``DeviceGroup``. The smoothing and flow PCGs multiply through the SpMV
kernels (kernels/spmv.py: ``spmv_ell_multi`` and ``spmv_ell``).

When ``arrays`` were placed on a group (``parallel/sharding.py::
place_problem``), the tensors whose leading axis was split hold this rank's
rows (``arrays.vrows``, ``arrays.frows``): the PCG vectors are then this
rank's rows too, each product gathers its x from every rank first
(``DeviceGroup.all_gather_rows``), and every dot product is summed over the
ranks. Everything else, and the result, is replicated.
"""

from __future__ import annotations

from typing import Tuple

import torch

from meshopticalflow_tpu_torch.flow.pipeline import _advected_vertex_signals
from meshopticalflow_tpu_torch.kernels.tracing import flow_field_trace
from meshopticalflow_tpu_torch.models.base import prolong, reduce_rhs
from meshopticalflow_tpu_torch.ops.dataterm import data_term_blocks
from meshopticalflow_tpu_torch.ops.ell import ell_matvec
from meshopticalflow_tpu_torch.solvers.cg import pcg, pcg_multi


def _resample_pair(arrays, tfield, smoothed, min_step, max_steps):
    """Both comparison signals advected in one trace of ``max_steps`` steps at
    most (the reference's kernels/advect.py::resample_signal_pair): the
    barycentre lanes 0..T-1 flow by -1/2 and sample channels [:C], lanes
    T..2T-1 by +1/2 and sample [C:]. Returns (V, 2C)."""
    t_count = arrays.tm.n_triangles
    kw = dict(dtype=smoothed.dtype, device=smoothed.device)
    t0 = torch.arange(t_count, device=smoothed.device).repeat(2)
    p0 = torch.full((2 * t_count, 2), 1.0 / 3.0, **kw)
    times = torch.cat([torch.full((t_count,), -0.5, **kw), torch.full((t_count,), 0.5, **kw)])
    t1, p1 = flow_field_trace(arrays.tm, tfield, times, t0, p0, min_step, max_steps)
    return _advected_vertex_signals(arrays, smoothed, t1, p1)


def flow_level_fixed(
    arrays,                      # flow.pipeline.ProblemArrays
    coeffs: torch.Tensor,
    tfield: torch.Tensor,
    s_weight,
    v_weight,
    smooth_iters: int = 64,
    flow_iters: int = 128,
    min_step: float = 1e-2,
    max_steps: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One UpdateFlow level (OpticalFlow.cpp:423-474) as a pure function.

    Returns (new_coeffs, new_tfield, alignment_error)."""
    ops, basis, signals = arrays.smooth_ops, arrays.basis, arrays.signals
    dtype = signals.dtype
    c = signals.shape[1] // 2
    s_weight = torch.as_tensor(s_weight, dtype=dtype, device=signals.device)
    v_weight = torch.as_tensor(v_weight, dtype=dtype, device=signals.device)
    vrows, frows = arrays.vrows, arrays.frows

    # Signal smoothing (M + wK)^-1 M s.
    sys_vals = ops.mass_vals + s_weight * ops.stiff_vals
    b = ell_matvec(ops.cols, ops.mass_vals, vrows.full(signals))
    diag = torch.gather(sys_vals, 1, ops.diag_slot[:, None])[:, 0]
    smoothed, _ = pcg_multi(vrows.matvec(ops.cols, sys_vals), b, diag,
                            x0=signals, tol=1e-30, max_iters=smooth_iters, rows=vrows)
    smoothed = vrows.full(smoothed)

    # Advect +-1/2 and build the data term.
    resampled = _resample_pair(arrays, tfield, smoothed, min_step, max_steps)
    res0, res1 = resampled[:, :c], resampled[:, c:]
    d_blocks, rhs_t = data_term_blocks(arrays.tm.triangles, arrays.area, res0, res1)

    # Regularized Gauss-Newton step (models/base.py::build_flow_system on
    # this rank's rows: the data term is assembled whole, then cut).
    n, w = basis.n_coeffs, basis.ell_width
    vals = torch.einsum("tak,tab,tbl->tkl", basis.p_wt, d_blocks, basis.p_wt)
    dt_flat = torch.zeros(n * w, dtype=dtype, device=vals.device).index_add_(
        0, basis.dt_slots, vals.reshape(-1))
    frob = torch.sqrt(torch.sum(dt_flat * dt_flat))
    scale = torch.where(frob > 0, 1.0 / frob, torch.zeros_like(frob))
    dt_vals = frows.local((dt_flat * scale).reshape(n, w))
    fsys = dt_vals + v_weight * basis.s_vals
    rhs = frows.local(reduce_rhs(basis, rhs_t) * scale)
    fdiag = torch.gather(fsys, 1, basis.diag_slot[:, None])[:, 0]
    x, _ = pcg(frows.matvec(basis.ell_cols, fsys), rhs, fdiag, tol=1e-30,
               max_iters=flow_iters, rows=frows)
    x_full = frows.full(x)
    dx = ell_matvec(basis.ell_cols, dt_vals, x_full)
    denom, num = frows.dot(x, dx), frows.dot(x, rhs)
    nz = denom != 0
    step = torch.where(nz, num / torch.where(nz, denom, torch.ones_like(denom)),
                       torch.zeros_like(num))
    new_coeffs = coeffs + step * x_full
    new_tfield = prolong(basis, new_coeffs)

    diff = res1 - res0
    mdiff = ell_matvec(ops.cols, ops.mass_vals, diff)
    align_err = vrows.dot(vrows.local(diff), mdiff)
    return new_coeffs, new_tfield, align_err
