"""Connection vector-field basis — per-triangle 2-vector DoFs with a
connection-Laplacian smoothness over the dual graph.

Rebuild of Src/Connection.inl: identity prolongation (Connection.inl:100-108)
and the dual-edge smoothness with three weight modes (Connection.inl:28-97):
per interior edge, weight l couples a triangle's vector to its neighbor's
parallel-transported vector: diagonal block += l*g_i, off-diagonal block
-l * g_i L where L transports from the neighbor chart into triangle i's.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from meshopticalflow_tpu_torch.config import ConnectionMode
from meshopticalflow_tpu_torch.geometry.mesh import EDGES, HostMesh
from meshopticalflow_tpu_torch.models.base import BasisHost


def _edge_weights(mesh: HostMesh, mode: ConnectionMode,
                  e: np.ndarray, oe: np.ndarray) -> np.ndarray:
    """Dual-edge weights for interior half-edges e (Connection.inl:56-71)."""
    t, j = e // 3, e % 3
    ot = oe // 3
    if mode == ConnectionMode.PROJECTED_BARYCENTRIC:
        # |edge|_g^2 / (4/3 (A_i + A_ii))
        ev = EDGES[j]
        l2 = np.einsum("ea,eab,eb->e", ev, mesh.g[t], ev)
        return l2 / (4.0 * (mesh.area[t] + mesh.area[ot]) / 3.0)
    if mode == ConnectionMode.BARYCENTRIC:
        # Barycentric areas / barycentric dual distance: the neighbor's
        # barycenter pulled into this chart via the opposite edge transform.
        center = np.array([1.0 / 3.0, 1.0 / 3.0])
        d = center - (np.einsum("eab,b->ea", mesh.xform_linear[oe], center)
                      + mesh.xform_const[oe])
        dist2 = np.einsum("ea,eab,eb->e", d, mesh.g[t], d)
        return ((mesh.area[t] + mesh.area[ot]) / 3.0) / dist2
    if mode == ConnectionMode.INVERSE_COTANGENT:
        oj = oe % 3
        cot_i = np.einsum("ea,eab,eb->e", -EDGES[(j + 1) % 3], mesh.g[t],
                          EDGES[(j + 2) % 3]) / (2.0 * mesh.area[t])
        cot_ii = np.einsum("ea,eab,eb->e", -EDGES[(oj + 1) % 3], mesh.g[ot],
                           EDGES[(oj + 2) % 3]) / (2.0 * mesh.area[ot])
        return 1.0 / (cot_i + cot_ii)
    raise ValueError(f"unknown connection mode {mode}")


def build_connection_basis(mesh: HostMesh,
                           mode: ConnectionMode = ConnectionMode.PROJECTED_BARYCENTRIC) -> BasisHost:
    t_count = mesh.n_triangles
    e = np.arange(3 * t_count)
    interior = mesh.opp >= 0
    e, oe = e[interior], mesh.opp[interior]
    t, ot = e // 3, oe // 3
    l = _edge_weights(mesh, mode, e, oe)

    # Diagonal blocks: sum_j l * g_i; off-diagonal: -l * g_i L_{ii->i}
    # (Connection.inl:78-92). L_{ii->i} is the xform stored on the OPPOSITE
    # half-edge (it maps the neighbor's chart into triangle i's).
    diag_blocks = np.zeros((t_count, 2, 2))
    np.add.at(diag_blocks, t, l[:, None, None] * mesh.g[t])
    off_blocks = -l[:, None, None] * np.einsum("eab,ebc->eac", mesh.g[t],
                                               mesh.xform_linear[oe])

    def block_coo(rows_t, cols_t, blocks):
        rr = (2 * rows_t[:, None, None] + np.arange(2)[None, :, None]
              + np.zeros((1, 1, 2), np.int64)).ravel()
        cc = (2 * cols_t[:, None, None] + np.zeros((1, 2, 1), np.int64)
              + np.arange(2)[None, None, :]).ravel()
        return rr, cc, blocks.ravel()

    r1, c1, v1 = block_coo(np.arange(t_count), np.arange(t_count), diag_blocks)
    r2, c2, v2 = block_coo(t, ot, off_blocks)
    smooth = sp.coo_matrix(
        (np.concatenate([v1, v2]), (np.concatenate([r1, r2]), np.concatenate([c1, c2]))),
        shape=(2 * t_count, 2 * t_count)).tocsr()

    p_idx = (2 * np.arange(t_count, dtype=np.int64)[:, None] + np.arange(2)[None, :])
    p_wt = np.broadcast_to(np.eye(2)[None], (t_count, 2, 2)).copy()
    return BasisHost(f"connection-{ConnectionMode(mode).name.lower()}", 2 * t_count,
                     p_idx, p_wt, smooth)
