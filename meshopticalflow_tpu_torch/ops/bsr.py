"""Sparse-pattern orderings (host numpy).

``rcm_permutation`` is a copy of meshopticalflow_tpu/ops/bsr.py:64; the
port's banded coarse solve (solvers/banded.py) orders its band with it.
The block-ELL packing of that module is a TPU layout and is not ported.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def rcm_permutation(a: sp.spmatrix) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of a symmetric sparse pattern."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    return np.asarray(reverse_cuthill_mckee(a.tocsr(), symmetric_mode=True))
