"""Multi-device scale-out over a ``DeviceGroup`` (one process per device).

Port of meshopticalflow_tpu/parallel/sharding.py. The reference lets GSPMD
partition jitted stages over a ``jax.sharding.Mesh``; the port writes the
same partitions out on torch.distributed:

  * data parallel over LANES: ``advect_texture_sharded`` gives each rank a
    contiguous block of the texel lanes and runs
    kernels/advect.py::advect_texture_compacted on it with the mesh tables
    replicated, with no traffic between ranks until the colours are
    gathered (lanes that do not divide the world size are padded with -1
    texels, which the reference asks its caller to do);
  * operator rows: ``place_problem`` keeps each rank's row block of the
    smoothing operators, the signals and the flow basis operator wherever
    the leading axis divides the world size (the reference's ``pick``
    replicates the rest, with no padding); the solvers then work on those
    rows through ``Rows`` (ops/rows.py, re-exported here): each product
    gathers x from every rank first (``all_gather_into_tensor``, the
    all-gather GSPMD inserts) and every dot product and norm is summed (or
    maxed) over the ranks.

``sharded_level_step`` is the fixed-iteration level step over a group: the
multi-device training-step path of the reference. flow/pipeline.py's
``FlowProblem`` places its production level step with ``place_problem``.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from meshopticalflow_tpu_torch.kernels.advect import advect_texture_compacted
from meshopticalflow_tpu_torch.ops.rows import Rows
from meshopticalflow_tpu_torch.parallel.distributed import DeviceGroup

__all__ = ["Rows", "place_problem", "sharded_level_step", "advect_texture_sharded"]


def place_problem(group: DeviceGroup, arrays):
    """``arrays`` (all rows) with this rank's row block of each tensor that
    ``pick`` splits (the counterpart of the reference's
    FlowProblem._place_on_mesh, flow/pipeline.py:851-871): the smoothing
    operators' cols, mass, stiffness, diagonal slots and lumped masses and
    the signals (when present) by V, the flow basis's ell_cols, s_vals and
    diagonal slots by n_coeffs. ``arrays.vrows`` / ``arrays.frows`` say
    which rows the rank holds. The identity at world size 1."""
    ops, basis, signals = arrays.smooth_ops, arrays.basis, arrays.signals
    if arrays.vrows.split or arrays.frows.split:
        raise ValueError("place_problem: arrays are placed already")
    vrows = Rows(ops.cols.shape[0], group)
    frows = Rows(basis.n_coeffs, group)
    ops = dataclasses.replace(
        ops, cols=vrows.local(ops.cols), mass_vals=vrows.local(ops.mass_vals),
        stiff_vals=vrows.local(ops.stiff_vals), diag_slot=vrows.local(ops.diag_slot),
        lumped=vrows.local(ops.lumped))
    basis = dataclasses.replace(basis, ell_cols=frows.local(basis.ell_cols),
                                s_vals=frows.local(basis.s_vals),
                                diag_slot=frows.local(basis.diag_slot))
    if signals is not None:
        signals = vrows.local(signals)
    return dataclasses.replace(arrays, smooth_ops=ops, basis=basis, signals=signals,
                               vrows=vrows, frows=frows)


def sharded_level_step(group: DeviceGroup, arrays, smooth_iters: int = 16,
                       flow_iters: int = 16, min_step: float = 1e-2,
                       max_steps: int = 128):
    """The fixed-iteration level step over ``group``. Returns (fn, placed).

    fn(placed, coeffs, tfield, s_weight, v_weight) -> (coeffs', tfield', err),
    every output replicated."""
    from meshopticalflow_tpu_torch.flow.fixed import flow_level_fixed

    placed = place_problem(group, arrays)
    fn = functools.partial(flow_level_fixed, smooth_iters=smooth_iters,
                           flow_iters=flow_iters, min_step=min_step,
                           max_steps=max_steps)
    return fn, placed


def advect_texture_sharded(group: DeviceGroup, tm, tfield, tri_uvs, texture, src_t,
                           src_p, length, min_step: float = 1e-2,
                           max_steps: int = 4096, bilinear: bool = True, quad=None):
    """Texel advection split over the lanes with the mesh tables replicated:
    rank r marches the r-th contiguous block of ``src_t`` / ``src_p`` (the
    lanes padded with -1 texels to a multiple of the world size), then the
    colours are gathered. Returns (colors (N, 3), lanes that hit the step
    cap, summed over the ranks)."""
    n = src_t.shape[0]
    pad = -n % group.world_size
    if pad:
        src_t = torch.cat([src_t, torch.full((pad,), -1, dtype=src_t.dtype,
                                             device=src_t.device)])
        src_p = torch.cat([src_p, torch.zeros((pad, 2), dtype=src_p.dtype,
                                              device=src_p.device)])
    lanes = Rows(src_t.shape[0], group)
    colors, _, _, exhausted = advect_texture_compacted(
        tm, tfield, tri_uvs, texture, lanes.local(src_t), lanes.local(src_p),
        length, min_step, max_steps, bilinear, quad=quad)
    count = group.all_reduce(torch.tensor([exhausted], dtype=torch.int64,
                                          device=colors.device))
    return lanes.full(colors)[:n], int(count[0])
