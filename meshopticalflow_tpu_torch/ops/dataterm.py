"""Per-triangle Gauss-Newton optical-flow data term.

Port of meshopticalflow_tpu/ops/dataterm.py (SetDataTerm,
OpticalFlow.cpp:394-421): for the averaged signal f = (s0 + s1)/2 on each
triangle, gamma = (f1 - f0, f2 - f0) is the signal differential in
barycentric coordinates; the normal equations per triangle are
D = sum_c gamma gamma^T * area and rhs = sum_c gamma * meanDiff * area.
The rhs uses the intended k<2 loop (the reference's k<3 reads out of bounds,
OpticalFlow.cpp:418).
"""

from __future__ import annotations

from typing import Tuple

import torch


def data_term_blocks(
    triangles: torch.Tensor,     # (T, 3) int
    area: torch.Tensor,          # (T,)
    values0: torch.Tensor,       # (V, C) resampled source signal
    values1: torch.Tensor,       # (V, C) resampled target signal
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns D: (T, 2, 2) and rhs: (T, 2)."""
    v0 = values0[triangles]      # (T, 3, C)
    v1 = values1[triangles]
    f = (v0 + v1) * 0.5
    mean_diff = torch.mean(v0 - v1, dim=1)                          # (T, C)
    gamma = torch.stack([f[:, 1] - f[:, 0], f[:, 2] - f[:, 0]], dim=1)  # (T, 2, C)
    d = torch.einsum("tkc,tlc->tkl", gamma, gamma) * area[:, None, None]
    rhs = torch.einsum("tkc,tc->tk", gamma, mean_diff) * area[:, None]
    return d, rhs
