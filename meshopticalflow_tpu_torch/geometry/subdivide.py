"""Midpoint subdivision until every edge is shorter than a threshold.

Rebuild of the reference Subdivide (Src/MeshFlow.inl:86-232): repeated
passes; in each pass every edge longer than ``edge_length`` gets a midpoint
vertex and each triangle is re-tessellated by its split-edge count (1, 2, or
3) using the reference's exact diamond patterns, preserving triangle emission
order. The uv variant carries wedge texture coordinates.

Vectorized numpy; edge here means the directed pair (corner j, corner j+1)
as in the reference subdivision code (not the FEM opposite-corner indexing).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _subdivide_pass(
    triangles: np.ndarray,
    vertices: np.ndarray,
    uvs: Optional[np.ndarray],
    edge_length: float,
    bary: Optional[np.ndarray] = None,   # (T, 3, 2) vertex barys in root tri
    parent: Optional[np.ndarray] = None,  # (T,) root triangle index
) -> tuple:
    nv = len(vertices)
    p0 = vertices[triangles]                      # (T, 3, 3)
    p1 = vertices[triangles[:, [1, 2, 0]]]
    l2 = ((p1 - p0) ** 2).sum(-1)                 # (T, 3)
    split = l2 > edge_length * edge_length
    n_split = int(split.sum())
    if n_split == 0:
        return triangles, vertices, uvs, parent, 0

    a = triangles.astype(np.int64)
    b = triangles[:, [1, 2, 0]].astype(np.int64)
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    keys = (lo << 32) | hi                        # (T, 3) undirected edge keys
    split_keys = keys[split]
    uniq, inverse = np.unique(split_keys, return_inverse=True)
    # Midpoint vertex per unique split edge.
    lo_u, hi_u = (uniq >> 32).astype(np.int64), (uniq & 0xFFFFFFFF).astype(np.int64)
    new_vertices = (vertices[lo_u] + vertices[hi_u]) / 2.0
    vertices = np.concatenate([vertices, new_vertices], axis=0)
    e = np.full(triangles.shape, -1, np.int64)    # midpoint vertex id per (t, j)
    e[split] = nv + inverse

    t = triangles.astype(np.int64)
    count = split.sum(axis=1)                     # 0..3 split edges per triangle
    out_count = np.where(count == 0, 1, np.where(count == 3, 4, count + 1))
    offsets = np.concatenate([[0], np.cumsum(out_count)])
    total = int(offsets[-1])
    out_tris = np.empty((total, 3), np.int64)
    if uvs is not None:
        d = uvs.shape[-1]
        uv_mid = np.empty(triangles.shape + (d,), np.float64)
        uv_mid[split] = (uvs[split] + uvs[:, [1, 2, 0]][split]) / 2.0
        out_uvs = np.empty((total, 3, d), np.float64)
    else:
        uv_mid = None
        out_uvs = None
    out_parent = None if parent is None else np.repeat(parent, out_count)

    def emit(rows, local_slot, i0, i1, i2, u0=None, u1=None, u2=None):
        dst = offsets[rows] + local_slot
        out_tris[dst, 0], out_tris[dst, 1], out_tris[dst, 2] = i0, i1, i2
        if out_uvs is not None:
            out_uvs[dst, 0], out_uvs[dst, 1], out_uvs[dst, 2] = u0, u1, u2

    # Unsplit triangles pass through.
    rows = np.nonzero(count == 0)[0]
    if len(rows):
        emit(rows, 0, t[rows, 0], t[rows, 1], t[rows, 2],
             *(None,) * 3 if uvs is None else (uvs[rows, 0], uvs[rows, 1], uvs[rows, 2]))

    for j in range(3):
        j1, j2 = (j + 1) % 3, (j + 2) % 3
        # One split edge at j (MeshFlow.inl:120-127 / 194-201).
        rows = np.nonzero((count == 1) & split[:, j])[0]
        if len(rows):
            if uvs is None:
                emit(rows, 0, t[rows, j], e[rows, j], t[rows, j2])
                emit(rows, 1, t[rows, j1], t[rows, j2], e[rows, j])
            else:
                emit(rows, 0, t[rows, j], e[rows, j], t[rows, j2],
                     uvs[rows, j], uv_mid[rows, j], uvs[rows, j2])
                emit(rows, 1, t[rows, j1], t[rows, j2], e[rows, j],
                     uvs[rows, j1], uvs[rows, j2], uv_mid[rows, j])
        # Two split edges, unsplit edge at j (MeshFlow.inl:128-136 / 202-210).
        rows = np.nonzero((count == 2) & ~split[:, j])[0]
        if len(rows):
            if uvs is None:
                emit(rows, 0, e[rows, j1], t[rows, j2], e[rows, j2])
                emit(rows, 1, t[rows, j], t[rows, j1], e[rows, j2])
                emit(rows, 2, t[rows, j1], e[rows, j1], e[rows, j2])
            else:
                emit(rows, 0, e[rows, j1], t[rows, j2], e[rows, j2],
                     uv_mid[rows, j1], uvs[rows, j2], uv_mid[rows, j2])
                emit(rows, 1, t[rows, j], t[rows, j1], e[rows, j2],
                     uvs[rows, j], uvs[rows, j1], uv_mid[rows, j2])
                emit(rows, 2, t[rows, j1], e[rows, j1], e[rows, j2],
                     uvs[rows, j1], uv_mid[rows, j1], uv_mid[rows, j2])
    # Three split edges -> 1-to-4 (MeshFlow.inl:137-141 / 211-215).
    rows = np.nonzero(count == 3)[0]
    if len(rows):
        for j in range(3):
            j2 = (j + 2) % 3
            if uvs is None:
                emit(rows, j, t[rows, j], e[rows, j], e[rows, j2])
            else:
                emit(rows, j, t[rows, j], e[rows, j], e[rows, j2],
                     uvs[rows, j], uv_mid[rows, j], uv_mid[rows, j2])
        if uvs is None:
            emit(rows, 3, e[rows, 0], e[rows, 1], e[rows, 2])
        else:
            emit(rows, 3, e[rows, 0], e[rows, 1], e[rows, 2],
                 uv_mid[rows, 0], uv_mid[rows, 1], uv_mid[rows, 2])
    return out_tris, vertices, out_uvs, out_parent, n_split


def subdivide_mesh(triangles: np.ndarray, vertices: np.ndarray,
                   edge_length: float) -> Tuple[np.ndarray, np.ndarray]:
    """Subdivide until all edges are <= edge_length (MeshFlow.inl:147-157)."""
    triangles = np.asarray(triangles, np.int64)
    vertices = np.asarray(vertices, np.float64)
    while True:
        triangles, vertices, _, _, n = _subdivide_pass(triangles, vertices, None, edge_length)
        if n == 0:
            return triangles.astype(np.int32), vertices


def subdivide_textured_mesh(
    triangles: np.ndarray, vertices: np.ndarray, uvs: np.ndarray, edge_length: float
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """uv-carrying variant (MeshFlow.inl:158-232); uvs is (T, 3, 2) wedge data."""
    triangles = np.asarray(triangles, np.int64)
    vertices = np.asarray(vertices, np.float64)
    uvs = np.asarray(uvs, np.float64)
    while True:
        triangles, vertices, uvs, _, n = _subdivide_pass(triangles, vertices, uvs, edge_length)
        if n == 0:
            return triangles.astype(np.int32), vertices, uvs


CORNER_BARY = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])


def subdivide_tracked(
    triangles: np.ndarray,
    vertices: np.ndarray,
    uvs: Optional[np.ndarray],
    edge_length: float,
):
    """Subdivision with coarse-parent tracking for geometric multigrid.

    Returns (tris, verts, uvs_or_None, parent (T,), bary (T, 3, 2)) where
    ``parent[t]`` is the ROOT (pre-subdivision) triangle containing fine
    triangle t and ``bary[t, j]`` the chart coordinates of its corners inside
    that root triangle. Barycentric tracking rides the wedge-attribute
    propagation (midpoint rule), exactly like the uv carrying.
    """
    triangles = np.asarray(triangles, np.int64)
    vertices = np.asarray(vertices, np.float64)
    t0 = len(triangles)
    bary0 = np.broadcast_to(CORNER_BARY[None], (t0, 3, 2)).copy()
    if uvs is not None:
        wedge = np.concatenate([np.asarray(uvs, np.float64), bary0], axis=2)
    else:
        wedge = bary0
    parent = np.arange(t0, dtype=np.int64)
    while True:
        triangles, vertices, wedge, parent, n = _subdivide_pass(
            triangles, vertices, wedge, edge_length, parent=parent)
        if n == 0:
            break
    if uvs is not None:
        out_uvs = wedge[:, :, :2]
        bary = wedge[:, :, 2:]
    else:
        out_uvs = None
        bary = wedge
    return (triangles.astype(np.int32), vertices, out_uvs,
            parent.astype(np.int32), bary)
