"""Carry problem state from the reference package into the port.

The reference package (meshopticalflow_tpu) keeps a problem's device state
as pytrees of jax arrays. The functions here read such state through
``np.asarray`` — duck-typed, so this module needs no jax — and build the
port's tensors from it:

  * ``problem_arrays``: the ``ProblemArrays`` leaves (``TraceMesh``,
    ``SmoothingOperators``, ``BasisDevice``, signals, area);
  * ``load_state``: coeffs, tfield and the texel table of a reference
    ``FlowProblem`` into a port ``FlowProblem`` of the same problem;
  * ``load_checkpoint``: a reference ``save_checkpoint`` ``.npz`` into a port
    ``FlowProblem``;
  * ``halo_from_reference``: a reference ``HaloEll`` layout (its arrays as
    numpy) as this rank's port ``HaloEll``, so the port's halo solvers can
    run on the reference's layout.

Index tables become int64 tensors, ELL column tables stay int32 (the SpMV
kernels' operand type), and values take the port problem's dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from meshopticalflow_tpu_torch.flow.pipeline import FlowProblem, ProblemArrays
from meshopticalflow_tpu_torch.flow.signal import SmoothingOperators
from meshopticalflow_tpu_torch.kernels.tracing import TraceMesh
from meshopticalflow_tpu_torch.models.base import BasisDevice

_INT32 = {"cols", "ell_cols"}
_INT64 = {"triangles", "opp", "diag_slot", "p_idx", "dt_slots", "src_t"}


def _leaf(name: str, value, dtype: torch.dtype, device) -> torch.Tensor:
    arr = np.array(value)                 # a writable host copy
    if name in _INT32:
        target = torch.int32
    elif name in _INT64:
        target = torch.int64
    else:
        target = dtype
    return torch.from_numpy(arr).to(device=device, dtype=target)


def _convert(cls, ref, dtype, device, **static):
    fields = {name: _leaf(name, getattr(ref, name), dtype, device)
              for name in cls.__dataclass_fields__ if name not in static}
    return cls(**fields, **static)


def problem_arrays(ref, dtype=torch.float64, device="cpu") -> ProblemArrays:
    """The port's ProblemArrays from the reference package's ProblemArrays
    (or any object with the same attribute tree of array-likes)."""
    return ProblemArrays(
        tm=_convert(TraceMesh, ref.tm, dtype, device),
        smooth_ops=_convert(SmoothingOperators, ref.smooth_ops, dtype, device),
        basis=_convert(BasisDevice, ref.basis, dtype, device,
                       n_coeffs=int(ref.basis.n_coeffs)),
        signals=_leaf("signals", ref.signals, dtype, device),
        area=_leaf("area", ref.area, dtype, device))


def load_state(problem: FlowProblem, ref_problem, texel_table: bool = True) -> None:
    """Copy a reference FlowProblem's state into ``problem``: its device
    arrays, coeffs, tfield and (texture problems, with ``texel_table``) the
    exp-remapped texel table."""
    dtype, device = problem.dtype, problem.device
    problem.arrays = problem_arrays(ref_problem.arrays, dtype, device)
    problem.coeffs = _leaf("coeffs", ref_problem.coeffs, dtype, device)
    problem.tfield = _leaf("tfield", ref_problem.tfield, dtype, device)
    if texel_table and getattr(ref_problem, "texture_source", None) is not None:
        problem.src_t = _leaf("src_t", ref_problem.src_t, dtype, device)
        problem.src_p = _leaf("src_p", ref_problem.src_p, dtype, device)
        problem._advect_order = None


def load_checkpoint(problem: FlowProblem, path: str):
    """Load a reference ``save_checkpoint`` file into ``problem`` (the two
    packages share the format); returns (level, s_weight, v_weight)."""
    return problem.load_checkpoint(path)


def halo_from_reference(perm, inv_perm, cols_local, vals_p, diag_p, n: int, block: int,
                        halo: int, group=None):
    """The port's ``HaloEll`` of ``group``'s rank from the reference's layout
    arrays (``perm``, ``inv_perm``: (n,); ``cols_local``, ``vals_p``:
    (block * world, W); ``diag_p``: (block * world,)), built for as many
    devices as the group has ranks. The local columns are clipped to the
    extended vector, as the reference clips them in its product
    (parallel/halo.py:94). ``group`` defaults to world size 1 on the CPU."""
    from meshopticalflow_tpu_torch.kernels.spmv import check_columns
    from meshopticalflow_tpu_torch.parallel.distributed import DeviceGroup
    from meshopticalflow_tpu_torch.parallel.halo import HaloEll

    group = group or DeviceGroup(None, 0, 1, torch.device("cpu"))
    cols_local = np.asarray(cols_local)
    if cols_local.shape[0] != block * group.world_size:
        raise ValueError(f"layout of {cols_local.shape[0]} rows is not {block} rows "
                         f"for each of {group.world_size} ranks")
    own = slice(group.rank * block, (group.rank + 1) * block)
    cols_own = np.ascontiguousarray(np.clip(cols_local[own], 0, block + 2 * halo - 1),
                                    np.int32)
    check_columns(cols_own, block + 2 * halo)
    vals = np.array(vals_p)
    dtype = torch.float64 if vals.dtype == np.float64 else torch.float32
    dev = group.device
    return HaloEll(group=group,
                   perm=torch.as_tensor(np.array(perm, np.int64)).to(dev),
                   inv_perm=torch.as_tensor(np.array(inv_perm, np.int64)).to(dev),
                   cols_local=torch.as_tensor(cols_own).to(dev),
                   vals_p=torch.as_tensor(np.ascontiguousarray(vals[own])).to(dev, dtype),
                   diag_p=torch.as_tensor(np.array(diag_p)[own].copy()).to(dev, dtype),
                   n=int(n), block=int(block), halo=int(halo))
