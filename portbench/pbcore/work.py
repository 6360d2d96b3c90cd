"""The work a kernel call needs, counted from its operands' sizes and
non-zero entries, never from a kernel's launch plan, so that a rewritten
kernel is judged on the same work (a copy of chip_smoke.py's bound
arithmetic); and the peaks of the card."""

from __future__ import annotations

import torch

# One NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM3 bytes/s.
HBM_BYTES_S = 3.35e12


def seconds_at_peak(nbytes: float) -> float:
    """The least time the card's memory needs to move ``nbytes``."""
    return nbytes / HBM_BYTES_S


def roofline_pct(nbytes: float, kernel_s: float):
    """Share of the memory roofline, in percent, or None without a reading."""
    if not nbytes or not kernel_s:
        return None
    return 100.0 * seconds_at_peak(nbytes) / kernel_s


def march_bytes(n_lanes: int, n_triangles: int, elem: int) -> int:
    """One march_field call over ``n_lanes`` lanes of a mesh of
    ``n_triangles``: every lane's start (triangle int64, point and flow
    time) and end (triangle, point) once, and the tables once: metric,
    opposite half-edges, transition maps and offsets, and the field. The
    tables are counted whole: every march here takes far more lane-steps
    than the tables have rows."""
    t = n_triangles
    tables = 3 * t * (8 + 6 * elem) + 4 * t * elem + 2 * t * elem
    lanes = n_lanes * (8 + 3 * elem) + n_lanes * (8 + 2 * elem)
    return lanes + tables


def spmv_bytes(nonzeros: int, value_elem: int, n_in: int, n_out: int, columns: int,
               x_elem: int) -> int:
    """One ELL product: each stored non-zero's value and 4-byte column once,
    x and y once."""
    return nonzeros * (value_elem + 4) + (n_in + n_out) * columns * x_elem


def banded_solve_bytes(panel_nonzeros: int, panel_elem: int, rhs_elems: int,
                       rhs_elem: int) -> int:
    """One exact c1 solve, a lower and an upper sweep: each reads the
    panels' non-zero entries once (the inverse diagonal blocks' lower
    halves and the blocks below them; the zeros of the band's profile are
    not counted) and reads and writes the right-hand side once."""
    return 2 * (panel_nonzeros * panel_elem + 2 * rhs_elems * rhs_elem)


class NonzeroCache:
    """Non-zero counts of operand tensors, counted once per tensor version."""

    def __init__(self):
        self._seen = {}

    def count(self, *tensors: torch.Tensor) -> int:
        total = 0
        for t in tensors:
            key = (t.data_ptr(), tuple(t.shape), t.dtype, t._version)
            if key not in self._seen:
                self._seen[key] = int((t != 0).sum())
            total += self._seen[key]
        return total
