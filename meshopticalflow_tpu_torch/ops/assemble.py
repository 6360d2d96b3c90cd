"""Host-side assembly of static geometry operators (scipy.sparse, float64).

The reference assembles these with atomic scatters into hand-rolled CSR
(FEM.inl:1506-1547); here they are one-shot COO sums on host — the results
are static for a run and ship to the device as padded ELL.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from meshopticalflow_tpu_torch.geometry.mesh import HostMesh
from meshopticalflow_tpu_torch.ops.elements import scalar_mass_elements, scalar_stiffness_elements


def _assemble_vertex_operator(mesh: HostMesh, elements: np.ndarray) -> sp.csr_matrix:
    """Scatter (T, 3, 3) element matrices into a V x V CSR."""
    tri = mesh.triangles.astype(np.int64)
    rows = np.repeat(tri, 3, axis=1).ravel()          # t,i,j -> tri[t,i]
    cols = np.tile(tri, (1, 3)).ravel()               # t,i,j -> tri[t,j]
    mat = sp.coo_matrix((elements.ravel(), (rows, cols)),
                        shape=(mesh.n_vertices, mesh.n_vertices))
    return mat.tocsr()


def scalar_mass_csr(mesh: HostMesh, lump: bool = False) -> sp.csr_matrix:
    """Scalar FEM mass matrix (FEM.inl:1548)."""
    return _assemble_vertex_operator(mesh, scalar_mass_elements(mesh.g, lump))


def scalar_stiffness_csr(mesh: HostMesh) -> sp.csr_matrix:
    """Scalar cotan stiffness matrix (FEM.inl:1549)."""
    return _assemble_vertex_operator(mesh, scalar_stiffness_elements(mesh.g))


def vector_field_mass_blocks(mesh: HostMesh) -> np.ndarray:
    """(T, 2, 2) per-triangle vector-field mass blocks g * area
    (FEM.inl:1609-1624)."""
    return mesh.g * mesh.area[:, None, None]
