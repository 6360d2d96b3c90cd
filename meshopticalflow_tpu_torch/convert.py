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
    ``FlowProblem``.

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
