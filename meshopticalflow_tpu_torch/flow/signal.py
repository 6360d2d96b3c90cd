"""Scalar-signal processing: screened-Poisson smoothing, DoG bands, log space.

Port of meshopticalflow_tpu/flow/signal.py (FlowData::smoothSignal,
OpticalFlow.cpp:330-349, and the comparison-signal construction,
OpticalFlow.cpp:820-857):

  * smoothing solves (M + w K) x = M s per channel, both signals at once,
    as one batched Jacobi-PCG on a shared-pattern ELL matrix;
  * the difference-of-Gaussians band: x_hi = s - (M + w K)^-1 M s,
    variance-renormalized against the original signal;
  * optional log-space transform of the inputs (OpticalFlow.cpp:821).

With a split ``rows`` (ops/rows.py's ``Rows``) the operators hold this
rank's row block of a split V (parallel/sharding.py::place_problem): a
signal passed in holds every row, a result holds this rank's rows, the
smoothing PCG runs on those rows (its products gather x, its dot products
are summed over the ranks), and the band's integrals and variances are
summed over the gathered rows (``_dog_renormalize``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from meshopticalflow_tpu_torch.geometry.mesh import HostMesh
from meshopticalflow_tpu_torch.ops.assemble import scalar_mass_csr, scalar_stiffness_csr
from meshopticalflow_tpu_torch.ops.ell import coo_slot_map, ell_from_scipy, ell_matvec
from meshopticalflow_tpu_torch.ops.rows import Rows
from meshopticalflow_tpu_torch.solvers.cg import ell_pcg


@dataclasses.dataclass
class SmoothingOperators:
    """Scalar mass/stiffness on one shared ELL pattern + lumped mass diag."""

    cols: torch.Tensor        # (V, W) int32
    mass_vals: torch.Tensor   # (V, W)
    stiff_vals: torch.Tensor  # (V, W)
    diag_slot: torch.Tensor   # (V,) int64
    lumped: torch.Tensor      # (V,) barycentric vertex areas


def make_smoothing_operators(mesh: HostMesh, dtype=torch.float32,
                             device="cpu") -> SmoothingOperators:
    mass = scalar_mass_csr(mesh, lump=False)
    stiff = scalar_stiffness_csr(mesh)
    # Identical sparsity (both 1-ring element-assembled); share the pattern.
    union = (mass + stiff).tocsr()
    ell = ell_from_scipy(union)

    def fill(csr):
        coo = csr.tocoo()
        slots = coo_slot_map(ell.cols, coo.row, coo.col)
        vals = np.zeros(ell.cols.size, np.float64)
        np.add.at(vals, slots, coo.data)
        return vals.reshape(ell.cols.shape)

    lumped = np.zeros(mesh.n_vertices)
    np.add.at(lumped, mesh.triangles.ravel(), np.repeat(mesh.area / 3.0, 3))

    def dev(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    return SmoothingOperators(
        cols=dev(ell.cols, torch.int32),
        mass_vals=dev(fill(mass), dtype),
        stiff_vals=dev(fill(stiff), dtype),
        diag_slot=dev(ell.diag_slot, torch.int64),
        lumped=dev(lumped, dtype),
    )


def _smooth_system(ops: SmoothingOperators, signal: torch.Tensor, weight):
    weight = torch.as_tensor(weight, dtype=signal.dtype, device=signal.device)
    sys_vals = ops.mass_vals + weight * ops.stiff_vals
    b = ell_matvec(ops.cols, ops.mass_vals, signal)
    diag = torch.gather(sys_vals, 1, ops.diag_slot[:, None])[:, 0]
    return sys_vals, b, diag


def smooth_signal(ops: SmoothingOperators, signal: torch.Tensor, weight,
                  tol: float = 1e-7, max_iters: int = 1000, chunk: int = 128,
                  rows: Optional[Rows] = None):
    """(M + w K)^-1 M s for a (V, C) signal (FlowData::smoothSignal):
    chunked PCG warm-started from the signal itself."""
    rows = rows or Rows(signal.shape[0])
    sys_vals, b, diag = _smooth_system(ops, signal, weight)
    return ell_pcg(ops.cols, sys_vals, diag, b, x0=rows.local(signal),
                   tol=tol, max_iters=max_iters, chunk=chunk, rows=rows)


def integral(ops: SmoothingOperators, x: torch.Tensor) -> torch.Tensor:
    """getIntegral (FEM.inl:2080-2097): lumped-mass weighted sum, per column."""
    return torch.einsum("v,vc->c", ops.lumped, x)


def _dog_renormalize(ops: SmoothingOperators, signal, smoothed,
                     rows: Optional[Rows] = None):
    """Variance renormalization of the high-pass band (OpticalFlow.cpp:830-853);
    ``smoothed`` and the band of this rank's rows under a split ``rows``.
    There the mass products run on this rank's rows and are gathered, and
    the integrals and variances are summed over every row on every rank:
    the variance int x^2 - (int x)^2 cancels in float32, and partial sums
    summed over the ranks moved the band by 4e-6 relative from one rank's
    on the CPU, where the sums over gathered rows equal one rank's bit for
    bit."""
    rows = rows or Rows(signal.shape[0])
    lumped = rows.full(ops.lumped)
    b = rows.full(ell_matvec(ops.cols, ops.mass_vals, signal))
    old_avg = torch.einsum("v,vc->c", lumped, signal)
    old_var = torch.einsum("vc,vc->c", signal, b) - old_avg * old_avg
    hi = signal - rows.full(smoothed)
    b_hi = rows.full(ell_matvec(ops.cols, ops.mass_vals, hi))
    new_avg = torch.einsum("v,vc->c", lumped, hi)
    new_var = torch.einsum("vc,vc->c", hi, b_hi) - new_avg * new_avg
    scale = torch.sqrt(old_var / torch.where(new_var > 0, new_var,
                                             torch.ones_like(new_var)))
    return rows.local((hi - new_avg[None, :]) * scale[None, :] + old_avg[None, :])


def dog_band(ops: SmoothingOperators, signal: torch.Tensor, dog_smooth,
             tol: float = 1e-8, max_iters: int = 2000,
             rows: Optional[Rows] = None) -> torch.Tensor:
    """Variance-renormalized high-pass band (OpticalFlow.cpp:822-854).

    signal: (V, C); returns the renormalized DoG band (V, C), this rank's
    rows of it under ``rows``.
    """
    smoothed, _ = smooth_signal(ops, signal, dog_smooth, tol, max_iters, rows=rows)
    return _dog_renormalize(ops, signal, smoothed, rows)


def log_space(signal: torch.Tensor) -> torch.Tensor:
    """log-space remap of a 0..255 signal (OpticalFlow.cpp:821)."""
    return torch.log(torch.clamp(signal, min=1.0)) * (255.0 / np.log(255.0))
