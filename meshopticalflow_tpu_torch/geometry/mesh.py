"""Intrinsic Riemannian triangle mesh — host-side preprocessing.

Rebuild of the reference FEM::RiemannianMesh geometry layer
(Misha/FEM.h:145-262) as vectorized numpy producing frozen, static-shape
arrays for the device:

  * per-triangle 2x2 metric ``g`` from the embedding or from (squared) edge
    lengths (FEM.inl:1303-1359), plus cached inverse (FEM.inl:1362-1369);
  * global unit-area normalization (FEM.inl:1282-1291);
  * half-edge pairing ``opp`` (FEM.inl:591-614) — edge index e = 3*t + j is
    the edge OPPOSITE corner j of triangle t, spanning corners (j+1)%3 and
    (j+2)%3;
  * the EdgeXForm chart-transition table (FEM.inl:549-590) as SoA arrays
    ``xform_linear`` (3T, 2, 2) and ``xform_const`` (3T, 2): the affine map
    from triangle t's barycentric chart into the neighboring triangle's;
  * ``sanity_check`` porting the invariants of FEM.inl:693-760.

All computation here is float64 numpy; device pipelines cast on upload.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# Barycentric chart corners of the reference right triangle (FEM.h:266).
CORNERS = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
# Hat-function gradients in chart coordinates (FEM.inl:489-492).
HAT_GRADS = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
# Chart edge vectors, edge j opposite corner j (FEM.h:268).
EDGES = np.array([[-1.0, 1.0], [0.0, -1.0], [1.0, 0.0]])


def rotate90(g: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Metric-aware 90-degree rotation (FEM.inl:17-24), batched.

    g: (..., 2, 2), v: (..., 2) -> (..., 2). w = g^-1 J v rescaled to |v|_g.
    """
    g = np.asarray(g, np.float64)
    v = np.asarray(v, np.float64)
    jv = np.stack([-v[..., 1], v[..., 0]], axis=-1)
    g_inv = np.linalg.inv(g)
    w = np.einsum("...ij,...j->...i", g_inv, jv)
    vn2 = np.einsum("...i,...ij,...j->...", v, g, v)
    wn2 = np.einsum("...i,...ij,...j->...", w, g, w)
    scale = np.where(wn2 > 0, np.sqrt(np.maximum(vn2, 0) / np.where(wn2 > 0, wn2, 1.0)), 1.0)
    return w * scale[..., None]


@dataclasses.dataclass
class HostMesh:
    """Frozen intrinsic mesh with chart-transition tables."""

    triangles: np.ndarray      # (T, 3) int32
    g: np.ndarray              # (T, 2, 2) float64 metric
    g_inv: np.ndarray          # (T, 2, 2) float64
    area: np.ndarray           # (T,) float64
    opp: np.ndarray            # (3T,) int32; opposite half-edge or -1
    xform_linear: np.ndarray   # (3T, 2, 2) float64
    xform_const: np.ndarray    # (3T, 2) float64
    n_vertices: int

    @property
    def n_triangles(self) -> int:
        return len(self.triangles)

    @property
    def total_area(self) -> float:
        return float(self.area.sum())


def _metric_from_embedding(triangles: np.ndarray, vertices: np.ndarray) -> np.ndarray:
    """Per-triangle first fundamental form (FEM.inl:1303-1323)."""
    p0 = vertices[triangles[:, 0]]
    e1 = vertices[triangles[:, 1]] - p0
    e2 = vertices[triangles[:, 2]] - p0
    g = np.empty((len(triangles), 2, 2), np.float64)
    g[:, 0, 0] = np.einsum("ij,ij->i", e1, e1)
    g[:, 1, 1] = np.einsum("ij,ij->i", e2, e2)
    g[:, 0, 1] = g[:, 1, 0] = np.einsum("ij,ij->i", e1, e2)
    return g


def _metric_from_square_edge_lengths(sq: np.ndarray) -> np.ndarray:
    """Metric from squared edge lengths, edge j opposite corner j (FEM.inl:1324-1359)."""
    g = np.empty((len(sq), 2, 2), np.float64)
    g[:, 0, 0] = sq[:, 2]
    g[:, 1, 1] = sq[:, 1]
    g[:, 0, 1] = g[:, 1, 0] = (sq[:, 2] + sq[:, 1] - sq[:, 0]) / 2.0
    return g


def _half_edge_opposites(triangles: np.ndarray) -> np.ndarray:
    """Pair directed half-edges (FEM.inl:591-614).

    Edge index 3t + (v+2)%3 carries the directed half-edge
    (tri[t][v] -> tri[t][(v+1)%3]); its opposite carries the reverse.
    """
    t_count = len(triangles)
    v0 = triangles  # corner v
    v1 = triangles[:, [1, 2, 0]]  # corner (v+1)%3
    idx = (np.arange(t_count)[:, None] * 3 + np.array([2, 0, 1])[None, :]).ravel()
    keys_fwd = v0.astype(np.int64).ravel() << 32 | v1.astype(np.int64).ravel()
    keys_bwd = v1.astype(np.int64).ravel() << 32 | v0.astype(np.int64).ravel()
    order = np.argsort(keys_fwd, kind="stable")
    sorted_keys = keys_fwd[order]
    if len(sorted_keys) != len(np.unique(sorted_keys)):
        raise ValueError("mesh has duplicated directed half-edges (non-manifold or inconsistently oriented)")
    pos = np.searchsorted(sorted_keys, keys_bwd)
    pos_clipped = np.clip(pos, 0, len(sorted_keys) - 1)
    matched = sorted_keys[pos_clipped] == keys_bwd
    opp = np.full(3 * t_count, -1, np.int32)
    opp_edge_of_halfedge = np.where(matched, idx[order][pos_clipped], -1)
    opp[idx] = opp_edge_of_halfedge
    return opp


def _edge_xforms(triangles: np.ndarray, g: np.ndarray, opp: np.ndarray):
    """Chart-transition affine maps per interior edge (FEM.inl:549-590).

    The linear part maps (edgeDir, edgePerp) in triangle t's chart onto
    (oppEdgeDir, oppEdgePerp) in the neighbor's chart; the constant takes
    the edge midpoint to the opposite edge midpoint.
    """
    t_count = len(triangles)
    e_total = 3 * t_count
    edges_idx = np.arange(e_total)
    interior = opp >= 0
    lin = np.zeros((e_total, 2, 2), np.float64)
    lin[:, 0, 0] = lin[:, 1, 1] = 1.0
    const = np.zeros((e_total, 2), np.float64)
    if not interior.any():
        return lin, const

    e = edges_idx[interior]
    oe = opp[interior]
    t, j = e // 3, e % 3
    ot, oj = oe // 3, oe % 3
    # Edge endpoints as chart corners: v = [(j+1)%3, (j+2)%3].
    c_v0 = CORNERS[(j + 1) % 3]
    c_v1 = CORNERS[(j + 2) % 3]
    c_ov0 = CORNERS[(oj + 1) % 3]
    c_ov1 = CORNERS[(oj + 2) % 3]
    edge_dir = c_v1 - c_v0
    oedge_dir = -(c_ov1 - c_ov0)
    gt, got = g[t], g[ot]

    def normalize(d, gg):
        n = np.sqrt(np.einsum("ij,ijk,ik->i", d, gg, d))
        return d / n[:, None]

    edge_dir = normalize(edge_dir, gt)
    oedge_dir = normalize(oedge_dir, got)
    perp = rotate90(gt, edge_dir)
    operp = rotate90(got, oedge_dir)
    # Columns are the direction/perp pairs (Misha SquareMatrix is column-major,
    # Geometry.h:130-147).
    M = np.stack([edge_dir, perp], axis=-1)
    oM = np.stack([oedge_dir, operp], axis=-1)
    L = oM @ np.linalg.inv(M)
    mid = (c_v0 + c_v1) / 2.0
    omid = (c_ov0 + c_ov1) / 2.0
    cvec = omid - np.einsum("ijk,ik->ij", L, mid)
    lin[e] = L
    const[e] = cvec
    return lin, const


def build_mesh(
    triangles: np.ndarray,
    vertices: Optional[np.ndarray] = None,
    edge_lengths: Optional[np.ndarray] = None,
    square_edge_lengths: Optional[np.ndarray] = None,
    make_unit_area: bool = True,
) -> HostMesh:
    """Build the intrinsic mesh from an embedding or an edge-length metric.

    Mirrors the reference init sequence: setMetricFrom{Embedding,EdgeLengths},
    makeUnitArea, setInverseMetric, getEdgeXForms (OpticalFlow.cpp:790-795).
    """
    triangles = np.ascontiguousarray(np.asarray(triangles, np.int32))
    if vertices is not None:
        g = _metric_from_embedding(triangles, np.asarray(vertices, np.float64))
    elif square_edge_lengths is not None:
        g = _metric_from_square_edge_lengths(np.asarray(square_edge_lengths, np.float64))
    elif edge_lengths is not None:
        g = _metric_from_square_edge_lengths(np.asarray(edge_lengths, np.float64) ** 2)
    else:
        raise ValueError("need vertices or edge lengths")
    det = np.linalg.det(g)
    if np.any(det <= 0):
        bad = int(np.sum(det <= 0))
        raise ValueError(f"{bad} triangles have a degenerate metric")
    if make_unit_area:
        # scale = 2 / sum(sqrt(det g)) -> total area 1 (FEM.inl:1282-1291)
        g = g * (2.0 / np.sqrt(det).sum())
    area = np.sqrt(np.linalg.det(g)) / 2.0
    g_inv = np.linalg.inv(g)
    opp = _half_edge_opposites(triangles)
    lin, const = _edge_xforms(triangles, g, opp)
    n_vertices = int(triangles.max()) + 1
    return HostMesh(triangles, g, g_inv, area, opp, lin, const, n_vertices)


def sanity_check(mesh: HostMesh, eps: float = 1e-8) -> None:
    """Invariant checks ported from RiemannianMesh::sanityCheck (FEM.inl:693-760)."""
    g = mesh.g
    if not np.allclose(g[:, 0, 1], g[:, 1, 0], atol=eps):
        raise AssertionError("metric not symmetric")
    tr = g[:, 0, 0] + g[:, 1, 1]
    det = np.linalg.det(g)
    disc = tr * tr - 4 * det
    lam_min = (tr - np.sqrt(np.maximum(disc, 0))) / 2
    if np.any(lam_min <= 0):
        raise AssertionError("metric not positive definite")

    interior = mesh.opp >= 0
    e = np.arange(len(mesh.opp))[interior]
    oe = mesh.opp[e]
    if not np.all(mesh.opp[oe] == e):
        raise AssertionError("opposite of opposite is not identity")
    t, j = e // 3, e % 3
    ot, oj = oe // 3, oe % 3
    tri, otri = mesh.triangles[t], mesh.triangles[ot]
    r = np.arange(len(e))
    if not (np.all(tri[r, (j + 1) % 3] == otri[r, (oj + 2) % 3])
            and np.all(tri[r, (j + 2) % 3] == otri[r, (oj + 1) % 3])):
        raise AssertionError("shared-edge vertices do not match")
    # Round trip is the identity.
    L, oL = mesh.xform_linear[e], mesh.xform_linear[oe]
    c, oc = mesh.xform_const[e], mesh.xform_const[oe]
    comp_lin = np.einsum("ijk,ikl->ijl", oL, L)
    comp_const = np.einsum("ijk,ik->ij", oL, c) + oc
    if not np.allclose(comp_lin, np.eye(2)[None], atol=1e-6):
        raise AssertionError("edge transforms are not inverses (linear)")
    if not np.allclose(comp_const, 0, atol=1e-6):
        raise AssertionError("edge transforms are not inverses (constant)")
    # Shared edge lengths agree.
    ev = CORNERS[(j + 1) % 3] - CORNERS[(j + 2) % 3]
    oev = CORNERS[(oj + 1) % 3] - CORNERS[(oj + 2) % 3]
    l1 = np.sqrt(np.einsum("ij,ijk,ik->i", ev, mesh.g[t], ev))
    l2 = np.sqrt(np.einsum("ij,ijk,ik->i", oev, mesh.g[ot], oev))
    if not np.allclose(l1, l2, rtol=1e-6):
        raise AssertionError("shared edge lengths disagree")
    # Edges and perpendiculars map into each other.
    e1 = ev
    e2 = -np.einsum("ijk,ik->ij", oL, oev)
    d = e1 - e2
    if np.any(np.einsum("ij,ijk,ik->i", d, mesh.g[t], d) > 1e-10):
        raise AssertionError("edges do not map into each other")
    p1 = rotate90(mesh.g[t], ev)
    p2 = -np.einsum("ijk,ik->ij", oL, rotate90(mesh.g[ot], oev))
    d = p1 - p2
    if np.any(np.einsum("ij,ijk,ik->i", d, mesh.g[t], d) > 1e-10):
        raise AssertionError("edge perpendiculars do not map into each other")
