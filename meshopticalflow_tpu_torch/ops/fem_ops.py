"""The reference's full vector-field FEM operator family, vectorized.

Rebuilds the remaining L4 operators of include/Misha/FEM.inl that round 1
left out (VERDICT r1, missing #5/#6): the tensor helpers
(TensorRoot/TraceForm/TraceWeights/LinearFit/CircularQuadratureWeights,
FEM.inl:26-301), the RightTriangle dual centers (:317-399), derivative
directions (:2118-2138), and the per-triangle vector-field operators —
rotate90 (:1587-1608), dot-mass (:1626-1651), the dual-graph stiffness
variants (:1683-1926), divergence (:1927-1956), and both covariant-
derivative traces (:1957-2047).

Everything is host-side numpy vectorized over triangles producing scipy
sparse operators in the reference's DoF layout (row 2t+k = chart component
k of triangle t) — these are static geometry built once; the solvers they
feed (Spectrum's Lanczos, the flow pipeline) run on device.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from meshopticalflow_tpu_torch.geometry.mesh import CORNERS, EDGES, HostMesh, rotate90

EDGE_MIDPOINTS = np.array([[0.5, 0.5], [0.0, 0.5], [0.5, 0.0]])  # FEM.h:267

# Dual types (FEM.h:52-58).
DUAL_BARYCENTRIC = 0
DUAL_CIRCUMCENTRIC = 1
DUAL_CIRCUMCENTER_PROJECTED_BARYCENTRIC = 2
DUAL_INCENTRIC = 3
DUAL_ISOGONIC = 4
DUAL_ISOGON_PROJECTED_BARYCENTRIC = 5
DUAL_COUNT = 6

# Quadrature flags (FEM.h:19-20).
QUADRATURE_ANGULAR = 1
QUADRATURE_SQUARE_LENGTH = 2


# ---------------------------------------------------------------------------
# Tensor helpers (FEM.inl:26-301)
# ---------------------------------------------------------------------------

def tensor_root(g: np.ndarray) -> np.ndarray:
    """Principal square root of SPD 2x2 tensors (FEM.inl:289-301), batched."""
    g = np.asarray(g, np.float64)
    det = np.linalg.det(g)
    if (det < 0).any():
        raise ValueError("negative determinant in tensor_root")
    s = np.sqrt(det)
    disc = g[..., 0, 0] + g[..., 1, 1] + 2.0 * s
    if (disc < 0).any():
        raise ValueError("negative discriminant in tensor_root")
    root = g.copy()
    root[..., 0, 0] += s
    root[..., 1, 1] += s
    return root / np.sqrt(disc)[..., None, None]


def trace_weights(g: np.ndarray, dirs: np.ndarray) -> np.ndarray:
    """Weights w (T, 3) with sum_i w_i dirs_i dirs_i^T = g^-1 (FEM.inl:188-211)."""
    g_inv = np.linalg.inv(g)
    idx = [(0, 0), (0, 1), (1, 1)]
    m = np.einsum("tki,tkj->tkij", dirs, dirs)              # (T, 3, 2, 2)
    # Row c of the 3x3 system: sum_i w_i M_i[idx_c] = g^-1[idx_c].
    a = np.stack([m[:, :, i0, i1] for (i0, i1) in idx], axis=1)  # (T, 3c, 3i)
    b = np.stack([g_inv[:, i0, i1] for (i0, i1) in idx], axis=-1)  # (T, 3)
    return np.linalg.solve(a, b[..., None])[..., 0]


def linear_fit(dirs: np.ndarray) -> np.ndarray:
    """Best-fit-linear-operator matrix (T, 6, 4) (FEM.inl:213-260).

    Row 2i+j maps per-direction values to the operator L with L(v_i)
    matching the inputs; columns are L's entries in row-major (L00,L01,
    L10,L11) order — L = W V^-1 with V = sum v v^T, W = e_j v_i^T."""
    t = dirs.shape[0]
    v = np.einsum("tki,tkj->tij", dirs, dirs)               # (T, 2, 2)
    v_inv = np.linalg.inv(v)
    fit = np.zeros((t, 6, 4))
    for i in range(3):
        for j in range(2):
            # Basis operator for unit value e_j at direction v_i:
            # L = e_j v_i^T V^-1 (the reference's OuterProduct in Misha's
            # (col,row) storage is exactly e_j v_i^T in math terms).
            w = np.zeros((t, 2, 2))
            w[:, j, :] = dirs[:, i, :]                       # e_j v_i^T
            l = np.einsum("tab,tbc->tac", w, v_inv)
            fit[:, 2 * i + j, 0] = l[:, 0, 0]
            fit[:, 2 * i + j, 1] = l[:, 0, 1]
            fit[:, 2 * i + j, 2] = l[:, 1, 0]
            fit[:, 2 * i + j, 3] = l[:, 1, 1]
    return fit


def _fit_rows_as_ops(fit: np.ndarray) -> np.ndarray:
    """(T, 6, 4) -> (T, 6, 2, 2) row-major operator per fit row."""
    t = fit.shape[0]
    return fit.reshape(t, 6, 2, 2)


def trace_form(g: np.ndarray, dirs: np.ndarray) -> np.ndarray:
    """(T, 6, 6) TraceForm (FEM.inl:27-50)."""
    fit_ops = _fit_rows_as_ops(linear_fit(dirs))            # (T, 6, 2, 2)
    g_inv = np.linalg.inv(g)
    # L_vw = g^-1 L_v^T g L_w ; tForm[i,j] = tr(L_vw)
    gl = np.einsum("tab,tjbc->tjac", g, fit_ops)            # g L_w
    lt_gl = np.einsum("tiba,tjbc->tijac", fit_ops, gl)      # L_v^T g L_w
    l_vw = np.einsum("tab,tijbc->tijac", g_inv, lt_gl)
    return l_vw[..., 0, 0] + l_vw[..., 1, 1]


def linear_fit_evaluation(dirs: np.ndarray) -> np.ndarray:
    """(T, 6, 6) LinearFitEvaluation (FEM.inl:52-78)."""
    fit_ops = _fit_rows_as_ops(linear_fit(dirs))            # (T, 6, 2, 2)
    ev = np.einsum("tiab,tjb->tija", fit_ops, dirs)          # (T, 6, 3, 2)
    t = dirs.shape[0]
    return ev.reshape(t, 6, 6)


def linear_fit_residual(dirs: np.ndarray) -> np.ndarray:
    return linear_fit_evaluation(dirs) - np.eye(6)[None]


def circular_quadrature_weights(g: np.ndarray, dirs: np.ndarray,
                                quadrature_type: int) -> np.ndarray:
    """(T, 3) CircularQuadratureWeights (FEM.inl:262-285), batched."""
    t = dirs.shape[0]
    if quadrature_type & QUADRATURE_ANGULAR:
        x = np.broadcast_to(np.array([1.0, 0.0]), (t, 2))
        y = rotate90(g, x)
        gx = np.einsum("tab,tb->ta", g, x)
        gy = np.einsum("tab,tb->ta", g, y)
        ang = np.arctan2(np.einsum("ta,tka->tk", gy, dirs),
                         np.einsum("ta,tka->tk", gx, dirs))   # (T, 3)
        angles = np.concatenate([ang, ang + np.pi], axis=1)   # (T, 6)
        idx6 = np.concatenate([np.arange(3), np.arange(3)])
        angles = np.mod(angles, 2 * np.pi)
        order = np.argsort(angles, axis=1)
        sa = np.take_along_axis(angles, order, axis=1)        # sorted (T, 6)
        ids = idx6[order]                                     # (T, 6)
        prev = np.roll(sa, 1, axis=1).copy()
        prev[:, 0] -= 2 * np.pi
        nxt = np.roll(sa, -1, axis=1).copy()
        nxt[:, -1] += 2 * np.pi
        span = (sa + nxt) / 2 - (sa + prev) / 2               # (T, 6)
        weights = np.zeros((t, 3))
        for k in range(6):
            np.add.at(weights, (np.arange(t), ids[:, k]), span[:, k])
    else:
        weights = np.full((t, 3), 2.0 * np.pi / 3)
    if quadrature_type & QUADRATURE_SQUARE_LENGTH:
        l = np.einsum("tka,tab,tkb->tk", dirs, g, dirs)
        weights = weights * l / l.sum(axis=1, keepdims=True)
    return weights


def mc_trace_form(g: np.ndarray, dirs: np.ndarray,
                  quadrature_type: int) -> np.ndarray:
    """(T, 6, 6) MCTraceForm (FEM.inl:80-97) — block diagonal."""
    t = dirs.shape[0]
    w = circular_quadrature_weights(g, dirs, quadrature_type) / np.pi
    w = w / np.einsum("tka,tab,tkb->tk", dirs, g, dirs)
    form = np.zeros((t, 6, 6))
    for i in range(3):
        form[:, 2 * i:2 * i + 2, 2 * i:2 * i + 2] = g * w[:, i, None, None]
    return form


# ---------------------------------------------------------------------------
# RightTriangle dual centers (FEM.inl:317-422)
# ---------------------------------------------------------------------------

def _intersect_max_det(c1, v1, c2, v2):
    """Per-row line intersection c1 + s v1 = c2 + t v2 -> (point, |det|)."""
    m = np.stack([-v1, v2], axis=-1)   # columns (-v1 | v2)
    det = np.abs(np.linalg.det(m))
    safe = det > 0
    m_safe = np.where(safe[..., None, None], m, np.eye(2))
    x = np.einsum("...ab,...b->...a", np.linalg.inv(m_safe), c1 - c2)
    pt = (c1 + v1 * x[..., 0:1] + c2 + v2 * x[..., 1:2]) / 2
    return pt, np.where(safe, det, 0.0)


def dual_center(g: np.ndarray, dual_type: int) -> np.ndarray:
    """(T, 2) RightTriangle::Center (FEM.inl:317-399), batched."""
    t = g.shape[0]
    if dual_type in (DUAL_BARYCENTRIC, DUAL_CIRCUMCENTER_PROJECTED_BARYCENTRIC,
                     DUAL_ISOGON_PROJECTED_BARYCENTRIC):
        return np.full((t, 2), 1.0 / 3.0)
    if dual_type == DUAL_INCENTRIC:
        lengths = np.sqrt(np.einsum("ka,tab,kb->tk", EDGES, g, EDGES))
        lsum = lengths.sum(1)
        return np.stack([lengths[:, 1] / lsum, lengths[:, 2] / lsum], -1)
    if dual_type == DUAL_CIRCUMCENTRIC:
        best = np.zeros((t, 2))
        best_det = np.zeros(t)
        for j in range(3):
            c1 = np.broadcast_to(EDGE_MIDPOINTS[(j + 1) % 3], (t, 2))
            c2 = np.broadcast_to(EDGE_MIDPOINTS[(j + 2) % 3], (t, 2))
            v1 = rotate90(g, np.broadcast_to(EDGES[(j + 1) % 3], (t, 2)))
            v2 = rotate90(g, np.broadcast_to(EDGES[(j + 2) % 3], (t, 2)))
            pt, det = _intersect_max_det(c1, v1, c2, v2)
            take = det > best_det
            best = np.where(take[:, None], pt, best)
            best_det = np.maximum(det, best_det)
        return best
    if dual_type == DUAL_ISOGONIC:
        sqrt34 = np.sqrt(3.0 / 4.0)
        ev = np.stack(
            [EDGE_MIDPOINTS[j] - rotate90(g, np.broadcast_to(EDGES[j], (t, 2)))
             * sqrt34 for j in range(3)], axis=1)            # (T, 3, 2)
        best = np.zeros((t, 2))
        best_det = np.zeros(t)
        for j in range(3):
            c1 = ev[:, (j + 1) % 3]
            c2 = ev[:, (j + 2) % 3]
            v1 = CORNERS[(j + 1) % 3] - c1
            v2 = CORNERS[(j + 2) % 3] - c2
            pt, det = _intersect_max_det(c1, v1, c2, v2)
            take = det > best_det
            best = np.where(take[:, None], pt, best)
            best_det = np.maximum(det, best_det)
        return best
    raise ValueError(f"unknown dual type {dual_type}")


def edge_reflect(g: np.ndarray, e: int, p: np.ndarray) -> np.ndarray:
    """RightTriangle::EdgeReflect (FEM.inl:418-422), batched over tensors."""
    t = g.shape[0]
    c = CORNERS[(e + 1) % 3]
    v = p - c
    perp = rotate90(g, np.broadcast_to(EDGES[e], (t, 2)))
    num = np.einsum("ta,tab,tb->t", perp, g, v)
    den = np.einsum("ta,tab,tb->t", perp, g, perp)
    return c + v - (2 * num / den)[:, None] * perp


def sub_triangle_areas(g: np.ndarray, center: np.ndarray) -> np.ndarray:
    """(T, 3) SubTriangleAreas (FEM.inl:402-413)."""
    t = g.shape[0]
    areas = np.zeros((t, 3))
    for i in range(3):
        p0 = np.broadcast_to(CORNERS[(i + 1) % 3], (t, 2))
        p1 = np.broadcast_to(CORNERS[(i + 2) % 3], (t, 2))
        e1 = p1 - p0
        e2 = center - p0
        r = rotate90(g, e1)
        areas[:, i] = np.einsum("ta,tab,tb->t", e2, g, r) / 2.0
    return areas


def center_areas(g: np.ndarray, dual_type: int) -> np.ndarray:
    return sub_triangle_areas(g, dual_center(g, dual_type))


def derivative_directions(mesh: HostMesh, dual_type: int) -> np.ndarray:
    """(T, 3, 2) setTriangleDerivativeDirections (FEM.inl:2118-2138)."""
    t_count = mesh.n_triangles
    g = mesh.g
    centers = dual_center(g, dual_type)                     # (T, 2)
    opp = mesh.opp
    e = np.arange(3 * t_count)
    tt = np.where(opp >= 0, opp // 3, 0)
    # Interior: xform on opp edge maps neighbor chart -> this chart.
    lin = mesh.xform_linear[np.maximum(opp, 0)]
    const = mesh.xform_const[np.maximum(opp, 0)]
    mapped = np.einsum("eab,eb->ea", lin, centers[tt]) + const
    dirs = mapped.reshape(t_count, 3, 2) - centers[:, None, :]
    # Boundary: reflect the center across the edge.
    for j in range(3):
        bnd = opp.reshape(t_count, 3)[:, j] < 0
        if bnd.any():
            refl = edge_reflect(g[bnd], j, centers[bnd])
            dirs[bnd, j] = refl - centers[bnd]
    if dual_type == DUAL_CIRCUMCENTER_PROJECTED_BARYCENTRIC:
        for j in range(3):
            d = rotate90(g, np.broadcast_to(EDGES[j], (t_count, 2)))
            num = np.einsum("ta,tab,tb->t", dirs[:, j], g, d)
            den = np.einsum("ta,tab,tb->t", d, g, d)
            dirs[:, j] = d * (num / den)[:, None]
    elif dual_type == DUAL_ISOGON_PROJECTED_BARYCENTRIC:
        iso = dual_center(g, DUAL_ISOGONIC)
        sqrt34 = np.sqrt(3.0 / 4.0)
        for j in range(3):
            d = EDGE_MIDPOINTS[j] - rotate90(
                g, np.broadcast_to(EDGES[j], (t_count, 2))) * sqrt34 - iso
            num = np.einsum("ta,tab,tb->t", dirs[:, j], g, d)
            den = np.einsum("ta,tab,tb->t", d, g, d)
            dirs[:, j] = d * (num / den)[:, None]
    return dirs


# ---------------------------------------------------------------------------
# Vector-field operators (2T x 2T unless noted)
# ---------------------------------------------------------------------------

def _block_diag_2x2(blocks: np.ndarray) -> sp.csr_matrix:
    """(T, 2, 2) per-triangle blocks -> block-diagonal (2T, 2T) CSR in the
    reference row layout: entry (2t+a, 2t+b) = block[t, a, b] (Misha's
    (col,row) element storage makes the reference's writes row-major in
    mathematical terms)."""
    t = blocks.shape[0]
    rows = (2 * np.arange(t)[:, None, None] + np.array([[0], [1]])[None]
            + np.zeros((1, 1, 2), np.int64)).ravel()
    cols = (2 * np.arange(t)[:, None, None] + np.zeros((1, 2, 1), np.int64)
            + np.arange(2)[None, None, :]).ravel()
    return sp.coo_matrix((blocks.ravel(), (rows, cols)),
                         shape=(2 * t, 2 * t)).tocsr()


def vector_field_rotate90_matrix(mesh: HostMesh) -> sp.csr_matrix:
    """vectorFieldRotate90Matrix (FEM.inl:1587-1608)."""
    j = np.array([[0.0, -1.0], [1.0, 0.0]])
    root = tensor_root(mesh.g)
    inv_root = np.linalg.inv(root)
    blocks = np.einsum("tab,bc,tcd->tad", inv_root, j, root)
    return _block_diag_2x2(blocks)


def vector_field_mass_matrix(mesh: HostMesh) -> sp.csr_matrix:
    """vectorFieldMassMatrix (FEM.inl:1609-1624): block-diag g * area."""
    return _block_diag_2x2(mesh.g * mesh.area[:, None, None])


def vector_field_dot_mass_matrix(mesh: HostMesh,
                                 vfield: np.ndarray) -> sp.csr_matrix:
    """vectorFieldDotMassMatrix (FEM.inl:1636-1651): g (v v^T a) g per tri."""
    m = np.einsum("ta,tb->tab", vfield, vfield) * mesh.area[:, None, None]
    blocks = np.einsum("tab,tbc,tcd->tad", mesh.g, m, mesh.g)
    return _block_diag_2x2(blocks)


def _interior_edge_arrays(mesh: HostMesh):
    t_count = mesh.n_triangles
    opp = mesh.opp
    e = np.arange(3 * t_count)
    interior = opp >= 0
    return t_count, opp, e, interior


def vector_field_stiffness_matrix(mesh: HostMesh,
                                  dual_type: int = DUAL_BARYCENTRIC,
                                  quadrature_type: int = 0) -> sp.csr_matrix:
    """vectorFieldStiffnessMatrix(edges, dualType, quadratureType)
    (FEM.inl:1737-1786): dual-graph finite differences with parallel
    transport; per-edge weight a/|dir|_g^2 * circular-quadrature weight."""
    t_count, opp, e, interior = _interior_edge_arrays(mesh)
    g = mesh.g
    dirs = derivative_directions(mesh, dual_type)
    w = circular_quadrature_weights(g, dirs, quadrature_type) / np.pi
    dgd = np.einsum("tka,tab,tkb->tk", dirs, g, dirs)
    edge_w = (mesh.area[:, None] / dgd * w).ravel()          # (3T,)

    s = np.where(interior, edge_w + edge_w[np.maximum(opp, 0)], 0.0)
    t_of_e = e // 3
    ii = np.maximum(opp, 0) // 3

    rows, cols, vals = [], [], []
    # Diagonal blocks: sum_j s * g (entry (k,l) -> stiffness[2i+l][.. 2i+k]
    # += s g(k,l) — i.e. block[l, k] += s g[k, l] = s g[l, k] symmetric).
    diag = np.zeros((t_count, 2, 2))
    np.add.at(diag, t_of_e, s[:, None, None] * g[t_of_e])
    bd = _block_diag_2x2(diag)
    # Off-diagonal: entry (2i+a, 2ii+b) = -s * (g_i @ L_opp)[a, b].
    xport = np.einsum("eab,ebc->eac", g[t_of_e], mesh.xform_linear[np.maximum(opp, 0)])
    mask = interior
    em = e[mask]
    blocks = -s[mask, None, None] * xport[mask]              # (E, 2, 2) [a,b]
    r = (2 * (em // 3))[:, None, None] + np.array([[[0, 0], [1, 1]]])  # a rows
    c = (2 * ii[mask])[:, None, None] + np.array([[[0, 1], [0, 1]]])   # b cols
    off = sp.coo_matrix((blocks.ravel(), (r.ravel(), c.ravel())),
                        shape=(2 * t_count, 2 * t_count)).tocsr()
    return (bd + off).tocsr()


def vector_field_stiffness_matrix_centers(mesh: HostMesh,
                                          centers: np.ndarray) -> sp.csr_matrix:
    """vectorFieldStiffnessMatrix(edges, centers) (FEM.inl:1683-1735):
    weights 2a/3 / |dir|_g^2 from explicit per-triangle centers."""
    t_count, opp, e, interior = _interior_edge_arrays(mesh)
    g = mesh.g
    t_of_e = e // 3
    lin = mesh.xform_linear[np.maximum(opp, 0)]
    const = mesh.xform_const[np.maximum(opp, 0)]
    tt = np.maximum(opp, 0) // 3
    mapped = np.einsum("eab,eb->ea", lin, centers[tt]) + const
    dirs = np.where(interior[:, None], mapped - centers[t_of_e], 1.0)
    dgd = np.einsum("ea,eab,eb->e", dirs, g[t_of_e], dirs)
    edge_w = np.where(interior, (mesh.area[t_of_e] / 3 * 2) / dgd, 0.0)

    s = np.where(interior, edge_w + edge_w[np.maximum(opp, 0)], 0.0)
    ii = np.maximum(opp, 0) // 3
    diag = np.zeros((t_count, 2, 2))
    np.add.at(diag, t_of_e, s[:, None, None] * g[t_of_e])
    bd = _block_diag_2x2(diag)
    xport = np.einsum("eab,ebc->eac", g[t_of_e], lin)
    mask = interior
    em = e[mask]
    blocks = -s[mask, None, None] * xport[mask]
    r = (2 * (em // 3))[:, None, None] + np.array([[[0, 0], [1, 1]]])
    c = (2 * ii[mask])[:, None, None] + np.array([[[0, 1], [0, 1]]])
    off = sp.coo_matrix((blocks.ravel(), (r.ravel(), c.ravel())),
                        shape=(2 * t_count, 2 * t_count)).tocsr()
    return (bd + off).tocsr()


def vector_field_stiffness_matrix_mc(mesh: HostMesh,
                                     dual_type: int = DUAL_BARYCENTRIC,
                                     quadrature_type: int = 0,
                                     linear_fit_: bool = False) -> sp.csr_matrix:
    """vectorFieldStiffnessMatrix_ (FEM.inl:1840-1926): Monte-Carlo trace
    form over the 8-dim (self + 3 neighbors) finite-difference space, with
    the optional linear-fit residual term. Reduces to the quadrature
    stiffness when linear_fit_ is False (FEM.h:217 property)."""
    t_count, opp, e, interior = _interior_edge_arrays(mesh)
    g = mesh.g
    dirs = derivative_directions(mesh, dual_type)
    opp_t = np.where(interior, np.maximum(opp, 0) // 3, -1).reshape(t_count, 3)

    # finiteDifference (T, 8, 6): rows = [self(2), nb0(2), nb1(2), nb2(2)],
    # cols = per-edge difference components.
    fd = np.zeros((t_count, 8, 6))
    lin = mesh.xform_linear[np.maximum(opp, 0)].reshape(t_count, 3, 2, 2)
    for v_ in range(3):
        has = opp_t[:, v_] >= 0
        for i in range(2):
            fd[has, i, 2 * v_ + i] = 1.0
            for j in range(2):
                # difference component (v, j) = (x_self - L x_nb)[j]
                fd[has, 2 * (v_ + 1) + i, 2 * v_ + j] = -lin[has, v_, j, i]

    if linear_fit_:
        tf = trace_form(g, dirs)
        res = linear_fit_residual(dirs)
        mc = mc_trace_form(g, dirs, quadrature_type)
        d = np.einsum("tji,tjk,tkl->til", res, mc, res)
        core = tf + d
    else:
        core = mc_trace_form(g, dirs, quadrature_type)
    form = np.einsum("tai,tij,tbj->tab", fd, core, fd) * mesh.area[:, None, None]

    # Scatter 4x4 blocks of 2x2 (reversed index note, FEM.inl:1888).
    t_idx = np.concatenate([np.arange(t_count)[:, None], opp_t], axis=1)  # (T,4)
    rows, cols, vals = [], [], []
    for i in range(4):
        for j in range(4):
            ok = (t_idx[:, i] >= 0) & (t_idx[:, j] >= 0)
            if not ok.any():
                continue
            ti, tj = t_idx[ok, i], t_idx[ok, j]
            blk = form[ok][:, 2 * i:2 * i + 2, 2 * j:2 * j + 2]
            for a in range(2):
                for b in range(2):
                    rows.append(2 * ti + a)
                    cols.append(2 * tj + b)
                    # Net of the reference's (col,row)-storage double
                    # reversal on the symmetric form: entry (2ti+a, 2tj+b)
                    # = form[2i+a, 2j+b].
                    vals.append(blk[:, a, b])
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    return sp.coo_matrix((vals, (rows, cols)),
                         shape=(2 * t_count, 2 * t_count)).tocsr()


def vector_field_divergence_matrix(mesh: HostMesh) -> sp.csr_matrix:
    """vectorFieldDivergenceMatrix (FEM.inl:1927-1956): (T, 2T)."""
    t_count, opp, e, interior = _interior_edge_arrays(mesh)
    g = mesh.g
    t_of_e = e // 3
    j_of_e = e % 3
    edge_vec = CORNERS[(j_of_e + 2) % 3] - CORNERS[(j_of_e + 1) % 3]
    rot = rotate90(g[t_of_e], edge_vec)
    grot = np.einsum("eab,eb->ea", g[t_of_e], rot)
    lin_t = np.transpose(mesh.xform_linear[np.maximum(opp, 0)], (0, 2, 1))
    vals = np.einsum("eab,eb->ea", lin_t, grot)
    vals = vals / (2.0 * mesh.area[t_of_e])[:, None]
    mask = interior
    ii = np.maximum(opp, 0) // 3
    rows = np.repeat(t_of_e[mask], 2)
    cols = (2 * ii[mask][:, None] + np.arange(2)[None]).ravel()
    return sp.coo_matrix((vals[mask].ravel(), (rows, cols)),
                         shape=(t_count, 2 * t_count)).tocsr()


def vector_field_covariant_derivative_trace_matrix(
        mesh: HostMesh, dual_type: int = DUAL_BARYCENTRIC) -> sp.csr_matrix:
    """vectorFieldCovariantDerivativeTraceMatrix (FEM.inl:1957-2003): (T, 2T)."""
    t_count, opp, e, interior = _interior_edge_arrays(mesh)
    g = mesh.g
    dirs = derivative_directions(mesh, dual_type)
    tw = trace_weights(g, dirs)                              # (T, 3)
    t_of_e = e // 3
    j_of_e = e % 3
    g_dir = np.einsum("eab,eb->ea", g[t_of_e],
                      dirs.reshape(-1, 2)) * tw.ravel()[:, None]
    mask = interior
    ii = np.maximum(opp, 0) // 3
    lin_t = np.transpose(mesh.xform_linear[np.maximum(opp, 0)], (0, 2, 1))
    nb_vals = np.einsum("eab,eb->ea", lin_t, g_dir)
    # self contribution: -g_dir summed over interior edges
    self_blocks = np.zeros((t_count, 2))
    np.add.at(self_blocks, t_of_e[mask], -g_dir[mask])
    rows_s = np.repeat(np.arange(t_count), 2)
    cols_s = (2 * np.arange(t_count)[:, None] + np.arange(2)[None]).ravel()
    m_self = sp.coo_matrix((self_blocks.ravel(), (rows_s, cols_s)),
                           shape=(t_count, 2 * t_count))
    rows_n = np.repeat(t_of_e[mask], 2)
    cols_n = (2 * ii[mask][:, None] + np.arange(2)[None]).ravel()
    m_nb = sp.coo_matrix((nb_vals[mask].ravel(), (rows_n, cols_n)),
                         shape=(t_count, 2 * t_count))
    return (m_self + m_nb).tocsr()


def vector_field_covariant_derivative_trace_matrix2(
        mesh: HostMesh, dual_type: int = DUAL_BARYCENTRIC) -> sp.csr_matrix:
    """vectorFieldCovariantDerivativeTraceMatrix2 (FEM.inl:2004-2047): the
    linear-fit-based trace, (T, 2T)."""
    t_count, opp, e, interior = _interior_edge_arrays(mesh)
    g = mesh.g
    dirs = derivative_directions(mesh, dual_type)
    fit = linear_fit(dirs)                                   # (T, 6, 4)
    # lFit rows for edge j: (T, 2, 4) — operator rows as row-major entries.
    mask = interior
    t_of_e = e // 3
    j_of_e = e % 3
    lf = fit.reshape(t_count, 3, 2, 4)[t_of_e, j_of_e]       # (3T, 2, 4)
    lf_ops = lf.reshape(-1, 2, 2, 2)                         # [k][row][col]
    lin = mesh.xform_linear[np.maximum(opp, 0)]
    lf2 = np.einsum("ekab,ebc->ekac", lf_ops, lin)
    self_val = -(lf_ops[:, :, 0, 0] + lf_ops[:, :, 1, 1])    # (3T, 2)
    nb_val = lf2[:, :, 0, 0] + lf2[:, :, 1, 1]
    ii = np.maximum(opp, 0) // 3
    self_blocks = np.zeros((t_count, 2))
    np.add.at(self_blocks, t_of_e[mask], self_val[mask])
    rows_s = np.repeat(np.arange(t_count), 2)
    cols_s = (2 * np.arange(t_count)[:, None] + np.arange(2)[None]).ravel()
    m_self = sp.coo_matrix((self_blocks.ravel(), (rows_s, cols_s)),
                           shape=(t_count, 2 * t_count))
    rows_n = np.repeat(t_of_e[mask], 2)
    cols_n = (2 * ii[mask][:, None] + np.arange(2)[None]).ravel()
    m_nb = sp.coo_matrix((nb_val[mask].ravel(), (rows_n, cols_n)),
                         shape=(t_count, 2 * t_count))
    return (m_self + m_nb).tocsr()


# ---------------------------------------------------------------------------
# Hat-gradient operator family (FEM.inl:1371-1469)
# ---------------------------------------------------------------------------

HAT_GRADIENT = 1
HAT_ROTATED_GRADIENT = 2
HAT_GRADIENT_AND_ROTATED_GRADIENT = 3


def gradient_matrix(mesh: HostMesh, grad_type: int = HAT_GRADIENT) -> sp.csr_matrix:
    """gradientMatrix (FEM.inl:1371-1403): (2T, V) / (2T, 2V)."""
    from meshopticalflow_tpu_torch.geometry.mesh import HAT_GRADS

    t_count = mesh.n_triangles
    v_count = mesh.n_vertices
    tri = mesh.triangles.astype(np.int64)
    g_inv = np.linalg.inv(mesh.g)
    grads = np.einsum("tab,kb->tka", g_inv, HAT_GRADS)       # (T, 3, 2)
    rows, cols, vals = [], [], []
    out_cols = 2 * v_count if grad_type == HAT_GRADIENT_AND_ROTATED_GRADIENT \
        else v_count
    off = 0
    if grad_type & HAT_GRADIENT:
        rows.append(np.repeat(2 * np.arange(t_count), 3))
        cols.append(tri.ravel())
        vals.append(grads[:, :, 0].ravel())
        rows.append(np.repeat(2 * np.arange(t_count) + 1, 3))
        cols.append(tri.ravel())
        vals.append(grads[:, :, 1].ravel())
        off = v_count if grad_type == HAT_GRADIENT_AND_ROTATED_GRADIENT else 0
    if grad_type & HAT_ROTATED_GRADIENT:
        perp = rotate90(mesh.g[:, None].repeat(3, 1), grads)
        rows.append(np.repeat(2 * np.arange(t_count), 3))
        cols.append(tri.ravel() + off)
        vals.append(perp[:, :, 0].ravel())
        rows.append(np.repeat(2 * np.arange(t_count) + 1, 3))
        cols.append(tri.ravel() + off)
        vals.append(perp[:, :, 1].ravel())
    return sp.coo_matrix((np.concatenate(vals),
                          (np.concatenate(rows), np.concatenate(cols))),
                         shape=(2 * t_count, out_cols)).tocsr()


def gradient_dual_matrix(mesh: HostMesh,
                         grad_type: int = HAT_GRADIENT) -> sp.csr_matrix:
    """gradientDualMatrix (FEM.inl:1404-1439): transpose of the gradient with
    g*area weighting — (V or 2V, 2T)."""
    from meshopticalflow_tpu_torch.geometry.mesh import HAT_GRADS

    t_count = mesh.n_triangles
    v_count = mesh.n_vertices
    tri = mesh.triangles.astype(np.int64)
    g_inv = np.linalg.inv(mesh.g)
    grads = np.einsum("tab,kb->tka", g_inv, HAT_GRADS)
    a = mesh.area
    rows, cols, vals = [], [], []
    out_rows = 2 * v_count if grad_type == HAT_GRADIENT_AND_ROTATED_GRADIENT \
        else v_count
    off = 0
    if grad_type & HAT_GRADIENT:
        gg = np.einsum("tab,tkb->tka", mesh.g, grads) * a[:, None, None]
        for comp in range(2):
            rows.append(tri.ravel())
            cols.append(np.repeat(2 * np.arange(t_count) + comp, 3))
            vals.append(gg[:, :, comp].ravel())
        off = v_count if grad_type == HAT_GRADIENT_AND_ROTATED_GRADIENT else 0
    if grad_type & HAT_ROTATED_GRADIENT:
        perp = rotate90(mesh.g[:, None].repeat(3, 1), grads)
        gp = np.einsum("tab,tkb->tka", mesh.g, perp) * a[:, None, None]
        for comp in range(2):
            rows.append(tri.ravel() + off)
            cols.append(np.repeat(2 * np.arange(t_count) + comp, 3))
            vals.append(gp[:, :, comp].ravel())
    return sp.coo_matrix((np.concatenate(vals),
                          (np.concatenate(rows), np.concatenate(cols))),
                         shape=(out_rows, 2 * t_count)).tocsr()


def set_gradient(mesh: HostMesh, vertex_values: np.ndarray,
                 grad_type: int = HAT_GRADIENT) -> np.ndarray:
    """Gradient EVALUATION form (setGradient, FEM.inl:1447-1469): per-triangle
    tangent 2-vectors from per-vertex scalars.

    For HAT_GRADIENT_AND_ROTATED_GRADIENT ``vertex_values`` carries 2V
    entries (hat half then rotated half, summed), matching the reference's
    offset convention."""
    tri = mesh.triangles.astype(np.int64)
    g_inv = np.linalg.inv(mesh.g)
    v_count = mesh.n_vertices
    out = np.zeros((mesh.n_triangles, 2))
    off = 0
    if grad_type & HAT_GRADIENT:
        vals = np.asarray(vertex_values)[tri]                # (T, 3)
        d = np.stack([vals[:, 1] - vals[:, 0], vals[:, 2] - vals[:, 0]], axis=1)
        out += np.einsum("tab,tb->ta", g_inv, d)
        off = v_count if grad_type == HAT_GRADIENT_AND_ROTATED_GRADIENT else 0
    if grad_type & HAT_ROTATED_GRADIENT:
        vals = np.asarray(vertex_values)[tri + off]
        d = np.stack([vals[:, 1] - vals[:, 0], vals[:, 2] - vals[:, 0]], axis=1)
        out += rotate90(mesh.g, np.einsum("tab,tb->ta", g_inv, d))
    return out


def gradient_mass_matrix(mesh: HostMesh,
                         grad_type: int = HAT_GRADIENT) -> sp.csr_matrix:
    """gradientMassMatrix (FEM.inl:1550-1555): G^T M_vf G."""
    g_mat = gradient_matrix(mesh, grad_type)
    m_vf = vector_field_mass_matrix(mesh)
    return (g_mat.T @ m_vf @ g_mat).tocsr()


def gradient_stiffness_matrix(mesh: HostMesh,
                              grad_type: int = HAT_GRADIENT) -> sp.csr_matrix:
    """gradientStiffnessMatrix (FEM.inl:1556-1585): the bi-stiffness
    K M_lumped^{-1} K (with M lumped by ROW SUM of the consistent mass),
    duplicated block-diagonally for the combined gradient type."""
    from meshopticalflow_tpu_torch.ops.assemble import (scalar_mass_csr,
                                                  scalar_stiffness_csr)

    k = scalar_stiffness_csr(mesh)
    m = scalar_mass_csr(mesh, lump=False)
    inv_row = 1.0 / np.asarray(m.sum(axis=1)).ravel()
    bi = (k @ sp.diags(inv_row) @ k).tocsr()
    if grad_type == HAT_GRADIENT_AND_ROTATED_GRADIENT:
        return sp.block_diag([bi, bi]).tocsr()
    return bi
