"""Whitney (DEC 1-form) vector-field basis — one DoF per undirected edge.

Rebuild of Src/Whitney.inl: edge reduction with orientation signs
(Whitney.inl:28-62), barycenter Whitney-interpolation prolongation
(Whitney.inl:65-88), and the smoothness operator
S = 0.5 * (d1^T m2 d1 + m1 d0 m0^-1 d0^T m1) from the DEC operators
(Whitney.inl:92-180), assembled host-side with scipy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp

from meshopticalflow_tpu_torch.geometry.mesh import HAT_GRADS, HostMesh
from meshopticalflow_tpu_torch.models.base import BasisHost


def edge_reduction(opp: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Undirected-edge indexing with orientation signs (Whitney.inl:28-62).

    Returns (reduced_index (3T,), sign (3T,) in {+1,-1}, expanded (E,)):
    first-visit scan order assigns reduced indices; the first-visited
    half-edge is positively oriented.
    """
    e = np.arange(len(opp))
    first = (opp < 0) | (e < opp)
    red_of_first = np.cumsum(first) - 1
    red = np.where(first, red_of_first, red_of_first[np.maximum(opp, 0)])
    sign = np.where(first, 1.0, -1.0)
    expanded = e[first]
    return red.astype(np.int64), sign, expanded


def build_whitney_basis(mesh: HostMesh) -> BasisHost:
    t_count = mesh.n_triangles
    tri = mesh.triangles.astype(np.int64)
    red, sign, expanded = edge_reduction(mesh.opp)
    e_count = len(expanded)

    # Prolongation: P row pair for triangle t, slot k (edge opposite corner k):
    # sign * g^-1 (grad_{k+2} - grad_{k+1}) / 3  (Whitney.inl:65-88).
    grad_diff = np.stack([(HAT_GRADS[(k + 2) % 3] - HAT_GRADS[(k + 1) % 3]) / 3.0
                          for k in range(3)])                      # (3, 2)
    wt = np.einsum("tab,kb->tak", mesh.g_inv, grad_diff)           # (T, 2, 3)
    wt = wt * sign.reshape(t_count, 3)[:, None, :]
    p_idx = red.reshape(t_count, 3)

    # DEC operators (Whitney.inl:92-180).
    exp_t, exp_v = expanded // 3, expanded % 3
    # d0: (E, V) rows (-1 at corner v+1, +1 at corner v+2) of the first-visit
    # half-edge.
    d0_rows = np.repeat(np.arange(e_count), 2)
    d0_cols = np.stack([tri[exp_t, (exp_v + 1) % 3], tri[exp_t, (exp_v + 2) % 3]], 1).ravel()
    d0_vals = np.tile([-1.0, 1.0], e_count)
    d0 = sp.coo_matrix((d0_vals, (d0_rows, d0_cols)), shape=(e_count, mesh.n_vertices)).tocsr()
    # d1: (T, E) with orientation signs.
    d1 = sp.coo_matrix(
        (sign, (np.repeat(np.arange(t_count), 3), red)), shape=(t_count, e_count)).tocsr()
    # m0: barycentric vertex areas (Whitney.inl:119-135).
    m0 = np.zeros(mesh.n_vertices)
    np.add.at(m0, tri.ravel(), np.repeat(mesh.area / 3.0, 3))
    # m1: cotan edge weights summed over both incident triangles
    # (Whitney.inl:137-160): per half-edge -area * <grad_{v+1}, g^-1 grad_{v+2}>.
    all_t = np.arange(3 * t_count) // 3
    all_v = np.arange(3 * t_count) % 3
    half = -mesh.area[all_t] * np.einsum(
        "ea,eab,eb->e", HAT_GRADS[(all_v + 1) % 3], mesh.g_inv[all_t], HAT_GRADS[(all_v + 2) % 3])
    m1 = np.zeros(e_count)
    np.add.at(m1, red, half)
    # m2 holds inverse triangle areas (Whitney.inl:163-173).
    m2_inv_area = 1.0 / mesh.area

    rot = d1.T @ sp.diags(m2_inv_area) @ d1
    div = sp.diags(m1) @ d0 @ sp.diags(1.0 / m0) @ d0.T @ sp.diags(m1)
    smooth = ((rot + div) * 0.5).tocsr()
    return BasisHost("whitney", e_count, p_idx, wt, smooth)
