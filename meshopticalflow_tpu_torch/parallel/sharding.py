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
  * operator rows: ``place_level_step`` keeps each rank's row block of
    every padded-ELL operator whose leading axis divides the world size
    (the reference's ``pick`` replicates the rest); ``flow_level_fixed``
    then gathers x from every rank before each local product
    (``all_gather_into_tensor``, the all-gather GSPMD inserts) and sums the
    CG dot products over the ranks.

``sharded_level_step`` is the fixed-iteration level step over a group: the
multi-device training-step path of the reference.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from meshopticalflow_tpu_torch.flow.fixed import flow_level_fixed
from meshopticalflow_tpu_torch.kernels.advect import advect_texture_compacted
from meshopticalflow_tpu_torch.parallel.distributed import DeviceGroup


def _splits(n: int, group: DeviceGroup) -> bool:
    """The reference's ``pick`` (parallel/sharding.py:60-64): a leading
    axis of ``n`` rows is split when it divides the world size."""
    w = group.world_size
    return n % w == 0 and n >= w


def _block(t: torch.Tensor, group: DeviceGroup) -> torch.Tensor:
    b = t.shape[0] // group.world_size
    return t[group.rank * b:(group.rank + 1) * b].contiguous()


def level_step_shardings(group: DeviceGroup, arrays) -> dict:
    """Which operators of ``arrays`` (flow.pipeline.ProblemArrays) are split
    by rows on ``group``: the smoothing operators (V rows) and the flow
    basis operator (n_coeffs rows). The trace tables, signals and the
    basis's prolongation are replicated."""
    return {"smooth_ops": _splits(arrays.smooth_ops.cols.shape[0], group),
            "basis": _splits(arrays.basis.n_coeffs, group)}


def place_level_step(group: DeviceGroup, arrays):
    """``arrays`` with this rank's row block of each split operator: the
    smoothing operators' cols, mass, stiffness and diagonal slots, the flow
    basis's ell_cols, s_vals and diagonal slots."""
    spec = level_step_shardings(group, arrays)
    ops, basis = arrays.smooth_ops, arrays.basis
    if spec["smooth_ops"]:
        ops = dataclasses.replace(ops, cols=_block(ops.cols, group),
                                  mass_vals=_block(ops.mass_vals, group),
                                  stiff_vals=_block(ops.stiff_vals, group),
                                  diag_slot=_block(ops.diag_slot, group))
    if spec["basis"]:
        basis = dataclasses.replace(basis, ell_cols=_block(basis.ell_cols, group),
                                    s_vals=_block(basis.s_vals, group),
                                    diag_slot=_block(basis.diag_slot, group))
    return dataclasses.replace(arrays, smooth_ops=ops, basis=basis)


def sharded_level_step(group: DeviceGroup, arrays, smooth_iters: int = 16,
                       flow_iters: int = 16, min_step: float = 1e-2,
                       max_steps: int = 128):
    """The fixed-iteration level step over ``group``. Returns (fn, placed).

    fn(placed, coeffs, tfield, s_weight, v_weight) -> (coeffs', tfield', err),
    every output replicated."""
    placed = place_level_step(group, arrays)
    fn = functools.partial(flow_level_fixed, smooth_iters=smooth_iters,
                           flow_iters=flow_iters, min_step=min_step,
                           max_steps=max_steps, group=group)
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
    colors, _, _, exhausted = advect_texture_compacted(
        tm, tfield, tri_uvs, texture, _block(src_t, group), _block(src_p, group),
        length, min_step, max_steps, bilinear, quad=quad)
    count = group.all_reduce(torch.tensor([exhausted], dtype=torch.int64,
                                          device=colors.device))
    return group.all_gather_rows(colors)[:n], int(count[0])
