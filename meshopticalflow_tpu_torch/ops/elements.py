"""Per-triangle FEM element matrices in closed form, batched over triangles.

Rebuild of FEM::RightTriangle (Misha/FEM.inl:424-498): exact integrals of
the hat basis over the reference right triangle under an arbitrary 2x2
metric. Pure numpy on (T, ...) arrays; the device never assembles these —
static operators are assembled on host, per-level terms use the
models' gather/scatter forms.
"""

from __future__ import annotations

import numpy as np

from meshopticalflow_tpu_torch.geometry.mesh import HAT_GRADS


def scalar_mass_elements(g: np.ndarray, lump: bool = False) -> np.ndarray:
    """(T, 3, 3) element mass matrices (FEM.inl:438-478).

    Consistent: sqrt(det g) * (1/12 on the diagonal, 1/24 off);
    lumped:     sqrt(det g) * 1/6 on the diagonal.
    """
    sdet = np.sqrt(np.linalg.det(g))
    if lump:
        base = np.eye(3) / 6.0
    else:
        base = np.full((3, 3), 1.0 / 24.0)
        np.fill_diagonal(base, 1.0 / 12.0)
    return sdet[:, None, None] * base[None]


def scalar_stiffness_elements(g: np.ndarray) -> np.ndarray:
    """(T, 3, 3) element stiffness: sqrt(det g)/2 * <grad_i, g^-1 grad_j>
    (FEM.inl:479-496)."""
    g_inv = np.linalg.inv(g)
    sdet = np.sqrt(np.linalg.det(g))
    k = np.einsum("ia,tab,jb->tij", HAT_GRADS, g_inv, HAT_GRADS)
    return 0.5 * sdet[:, None, None] * k


def hat_gradients(g: np.ndarray) -> np.ndarray:
    """(T, 3, 2) chart gradients g^-1 grad_j of the three hat functions
    (FEM.inl:498)."""
    g_inv = np.linalg.inv(g)
    return np.einsum("tab,jb->tja", g_inv, HAT_GRADS)
