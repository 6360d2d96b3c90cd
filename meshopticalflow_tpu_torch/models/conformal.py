"""Conformal vector-field basis — gradients + rotated gradients of hat
functions (2V coefficients; cannot represent harmonic fields, FEM.h:191-193).

Rebuild of Src/Conformal.inl: prolongation rows carry g^-1 grad_k and
rotGrad_k / sqrt(det g) (Conformal.inl:49-77); the smoothness operator is
0.5 * K M_lump^-1 K duplicated on both coefficient halves
(Conformal.inl:18-46).

``divergence_free=True`` restricts the basis to the rotated-gradient half —
the documented intent of the reference's --divFree flag (OpticalFlow.cpp:783,
vestigial on the reference's active path).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from meshopticalflow_tpu_torch.geometry.mesh import HAT_GRADS, HostMesh
from meshopticalflow_tpu_torch.models.base import BasisHost
from meshopticalflow_tpu_torch.ops.assemble import scalar_mass_csr, scalar_stiffness_csr

# Rotated hat gradients in chart coordinates (Conformal.inl:54): constants,
# the metric enters through the 1/sqrt(det g) factor.
ROT_GRADS = np.array([[1.0, -1.0], [0.0, 1.0], [-1.0, 0.0]])


def build_conformal_basis(mesh: HostMesh, divergence_free: bool = False) -> BasisHost:
    t_count = mesh.n_triangles
    v_count = mesh.n_vertices
    tri = mesh.triangles.astype(np.int64)

    grad_wt = np.einsum("tab,kb->tak", mesh.g_inv, HAT_GRADS)          # (T, 2, 3)
    inv_sqrt_det = 1.0 / np.sqrt(np.linalg.det(mesh.g))
    rot_wt = np.broadcast_to(ROT_GRADS.T[None], (t_count, 2, 3)) * inv_sqrt_det[:, None, None]

    stiffness = scalar_stiffness_csr(mesh)
    lumped_diag = scalar_mass_csr(mesh, lump=True).diagonal()
    s_half = (stiffness @ sp.diags(1.0 / lumped_diag) @ stiffness) * 0.5

    if divergence_free:
        p_idx = tri
        p_wt = rot_wt
        smooth = s_half.tocsr()
        return BasisHost("conformal-divfree", v_count, p_idx, p_wt, smooth)

    p_idx = np.concatenate([tri, tri + v_count], axis=1)               # (T, 6)
    p_wt = np.concatenate([grad_wt, rot_wt], axis=2)                   # (T, 2, 6)
    smooth = sp.block_diag([s_half, s_half], format="csr")
    return BasisHost("conformal", 2 * v_count, p_idx, p_wt, smooth)
