"""The rows of an operator that one rank of a ``DeviceGroup`` holds.

The row-block helper that the solvers (solvers/cg.py, solvers/refine.py,
solvers/mg3.py), the signal processing (flow/signal.py), the level step
(models/base.py, flow/pipeline.py, flow/fixed.py) and the placement
(parallel/sharding.py::place_problem, which re-exports it) share. It splits
by the reference's ``pick`` rule (meshopticalflow_tpu/parallel/sharding.py:
60-64): a leading axis of ``n`` rows is cut into equal contiguous blocks
when ``n`` divides the world size, else every rank holds all of it (no
padding). Without a group, or when ``n`` is not split, every method is the
identity or a plain local reduction, so one code path serves both.

It lives here and not in parallel/ because importing the parallel package
imports parallel/halo.py, which imports solvers/cg.py.
"""

from __future__ import annotations

from typing import Optional

import torch

from meshopticalflow_tpu_torch.ops.ell import ell_matvec


def splits(n: int, world_size: int) -> bool:
    """The reference's ``pick``: ``n`` rows are split when they divide the
    world size."""
    return n % world_size == 0 and n >= world_size


class Rows:
    """The rows of an ``n``-row operator or vector that this rank holds:
    the rank's contiguous block when ``group`` has two or more ranks and
    ``pick`` splits ``n``, else all of them (``group`` is then None)."""

    def __init__(self, n: int, group=None):
        split = group is not None and group.world_size > 1 and splits(n, group.world_size)
        self.group = group if split else None
        self.n = n
        self.n_local = n // group.world_size if split else n
        start = group.rank * self.n_local if split else 0
        self.sl = slice(start, start + self.n_local)

    @property
    def split(self) -> bool:
        return self.group is not None

    def local(self, v: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a tensor that holds all ``n``: a copy of its
        own, so that the whole can be freed and the rows start on a fresh
        (16-byte aligned) allocation, as the SpMV kernels require."""
        return v[self.sl].clone() if self.split else v

    def full(self, v: torch.Tensor) -> torch.Tensor:
        """A tensor of this rank's rows, gathered to all rows."""
        return v if self.group is None else self.group.all_gather_rows(v)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """A partial sum over this rank's rows, summed over the ranks."""
        return t if self.group is None else self.group.all_reduce(t)

    def dot(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """sum(u * v) over all rows, for u, v of this rank's rows."""
        return self.sum(torch.sum(u * v))

    def norm(self, v: torch.Tensor) -> torch.Tensor:
        """The 2-norm over all rows of a vector of this rank's rows."""
        if self.group is None:
            return torch.linalg.vector_norm(v)
        return torch.sqrt(self.group.all_reduce(torch.sum(v * v)))

    def amax(self, v: torch.Tensor) -> torch.Tensor:
        """max |v| over all rows, for v of this rank's rows."""
        m = torch.max(torch.abs(v))
        return m if self.group is None else self.group.all_reduce(m, op="max")

    def matvec(self, cols, vals):
        """The product of an operator of this rank's rows (against all
        columns) with a vector of this rank's rows."""
        return lambda v: ell_matvec(cols, vals, self.full(v))
