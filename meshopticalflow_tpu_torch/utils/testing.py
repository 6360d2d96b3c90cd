"""Synthetic meshes and oracles shared by the port's tests and chip_smoke.py.

Jax-free: ``octa_sphere`` is a copy of meshopticalflow_tpu/utils/testing.py's
(drift guard: tests/test_torch_host.py::HOST_COPIES); ``arpack_spectrum`` is
the spectrum's reference on the card, where no JAX package is installed;
``halo_test_system`` is the halo solvers' system on the card;
``flat_grid`` and ``march_lanes`` are the march kernels' meshes and lanes;
``band_test_blocks`` the banded kernels' systems; ``main_path_mesh`` the
bake kernel's mesh.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def octa_sphere(subdiv: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """Closed octahedron-based sphere mesh (all edges interior)."""
    verts = [np.array(v, np.float64) for v in
             [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]]
    tris = [(0, 2, 4), (2, 1, 4), (1, 3, 4), (3, 0, 4),
            (2, 0, 5), (1, 2, 5), (3, 1, 5), (0, 3, 5)]
    for _ in range(subdiv):
        cache = {}
        new_tris = []

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = verts[i] + verts[j]
                m /= np.linalg.norm(m)
                cache[key] = len(verts)
                verts.append(m)
            return cache[key]

        for a, b, c in tris:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_tris += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        tris = new_tris
    return np.array(tris, np.int32), np.stack(verts)


def flat_grid(n: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """A flat [0,1]^2 grid of n x n vertices in 3-D: a mesh with a boundary."""
    xs, ys = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n), indexing="ij")
    pts = np.stack([xs.ravel(), ys.ravel(), np.zeros(n * n)], axis=1)
    tris = []
    for i in range(n - 1):
        for j in range(n - 1):
            a, b, c, d = i * n + j, (i + 1) * n + j, (i + 1) * n + j + 1, i * n + j + 1
            tris += [[a, b, c], [a, c, d]]
    return np.array(tris, np.int32), pts


def march_lanes(opp: np.ndarray, n: int, seed: int = 3) -> dict:
    """Lanes for the march kernels' tests on a mesh of half-edge opposites
    ``opp`` (3T,), from a seed: a per-triangle field (every 7th triangle's
    zero), the signed half-edge Whitney coefficients (3T,) of a random
    1-form (Whitney.inl:28-62), starts (every 13th lane inactive, t = -1;
    every 5th on chart edge 1, the next on chart edge 2), flow times of both
    signs, exp_map displacements."""
    from meshopticalflow_tpu_torch.models.whitney import edge_reduction

    n_triangles = len(opp) // 3
    rng = np.random.default_rng(seed)
    red, sign, expanded = edge_reduction(np.asarray(opp))
    field = rng.normal(scale=0.4, size=(n_triangles, 2))
    field[::7] = 0.0
    t0 = rng.integers(0, n_triangles, n)
    t0[::13] = -1
    p0 = rng.uniform(0.05, 0.45, (n, 2))
    p0[::5, 0] = 0.0
    p0[1::5, 1] = 0.0
    ce = rng.normal(scale=0.4, size=len(expanded))[red] * sign
    return dict(field=field, ce=ce, t0=t0, p0=p0, times=rng.uniform(-1.5, 1.5, n),
                v=rng.normal(scale=0.8, size=(n, 2)))


def arpack_spectrum(host, mesh, k: int):
    """scipy's ARPACK in shift-invert mode (sigma 1e-8, the reference's
    solver, EigenvalueSolver.h:176) on the float64 host operators S and
    M = P^T (g area) P, from a seeded start (tests/test_spectrum.py,
    scripts/bench_spectrum.py). Returns the k eigenvalues, ascending."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    t, kk = host.p_idx.shape
    rows = np.repeat(np.arange(2 * t).reshape(t, 2), kk, axis=1).ravel()
    cols = np.repeat(host.p_idx[:, None, :], 2, axis=1).ravel()
    p = sp.coo_matrix((host.p_wt.ravel(), (rows, cols)), shape=(2 * t, host.n_coeffs)).tocsr()
    g = sp.bsr_matrix((mesh.g * mesh.area[:, None, None], np.arange(t), np.arange(t + 1)),
                      shape=(2 * t, 2 * t))
    m = (p.T @ (g @ p)).tocsc()
    v0 = np.random.default_rng(7).normal(size=host.n_coeffs)
    lams = spla.eigsh(sp.csc_matrix(host.smooth), k=k, M=m, sigma=1e-8, which="LM", v0=v0,
                      return_eigenvectors=False)
    return np.sort(lams)


def halo_test_system(subdiv: int):
    """A shifted Whitney smoothness system on the sphere (float64 numpy: its
    ELL ``cols``, ``vals`` and scipy matrix ``a``), a right-hand side ``b``
    from a seed, and an aggregation coarse space for the halo multigrid
    solve: fine row i -> coarse row i // 4, weight 1 (``p0_idx``,
    ``p0_wt``), with the Galerkin coarse operator as padded ELL (``c1_cols``,
    ``c1_vals``)."""
    import scipy.sparse as sp

    from meshopticalflow_tpu_torch.config import FlowConfig
    from meshopticalflow_tpu_torch.geometry.mesh import build_mesh
    from meshopticalflow_tpu_torch.models.base import build_basis
    from meshopticalflow_tpu_torch.ops.ell import ell_from_scipy

    tris, verts = octa_sphere(subdiv)
    _, basis = build_basis(build_mesh(tris, vertices=verts), FlowConfig(dtype="float64"), "cpu")
    cols = basis.ell_cols.numpy()
    vals = basis.s_vals.numpy().copy()
    n, w = cols.shape
    vals[np.arange(n), basis.diag_slot.numpy()] += 1e-2
    a = sp.csr_matrix((vals.ravel(), (np.repeat(np.arange(n), w), cols.ravel())), shape=(n, n))
    p0_idx = (np.arange(n) // 4)[:, None]
    p0_wt = np.ones((n, 1))
    p = sp.csr_matrix((p0_wt[:, 0], (np.arange(n), p0_idx[:, 0])), shape=(n, p0_idx.max() + 1))
    c1 = ell_from_scipy((p.T @ a @ p).tocsr())
    return dict(cols=cols, vals=vals, a=a, p0_idx=p0_idx, p0_wt=p0_wt, c1_cols=c1.cols,
                c1_vals=c1.vals, b=np.random.default_rng(5).normal(size=n))


def band_test_blocks(m: int, nb: int, bw: int, seed: int = 0,
                     indefinite: bool = False) -> np.ndarray:
    """Band blocks (m, nb + bw, nb), float64, in solvers/banded.py's layout
    (step i's rows i*nb + r, columns i*nb + c; the diagonal block's strict
    upper half zero) of a symmetric matrix of order m * nb and semiband bw:
    off-diagonal entries from U(-1, 1) / (2 bw + 1) and a diagonal from
    U(1, 2), so diagonally dominant and positive definite; ``indefinite``
    makes the first diagonal entry of step m // 2 -1, so the factorization
    breaks down there and a diagonal shift of 1.5 or more repairs it."""
    rng = np.random.default_rng(seed)
    r = np.arange(nb + bw)[:, None]
    c = np.arange(nb)[None, :]
    keep = (r >= c) & (r - c <= bw)
    blocks = rng.uniform(-1.0, 1.0, (m, nb + bw, nb)) / (2 * bw + 1) * keep
    blocks[:, np.arange(nb), np.arange(nb)] = rng.uniform(1.0, 2.0, (m, nb))
    rows = np.arange(m)[:, None, None] * nb + r[None]
    blocks[np.broadcast_to(rows >= m * nb, blocks.shape)] = 0.0
    if indefinite:
        blocks[m // 2, 0, 0] = -1.0
    return blocks


def main_path_mesh(cube_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """The main path's textured mesh from the golden cube ``cube_path``:
    subdivided to the 24,576-triangle root (0.024 of its diagonal), then at
    the OpticalFlow CLI's default edge length (0.006): 393,216 triangles,
    196,610 vertices. Returns (triangles (T, 3) int32, wedge uvs (T, 3, 2)
    float64)."""
    from meshopticalflow_tpu_torch.geometry.subdivide import subdivide_tracked
    from meshopticalflow_tpu_torch.io.ply import read_triangle_mesh

    data = read_triangle_mesh(cube_path)
    diag = float(np.linalg.norm(data.vertices.max(0) - data.vertices.min(0)))
    tris, verts, uvs = data.faces, data.vertices, data.face_uvs
    for fraction in (0.024, 0.006):
        tris, verts, uvs, _, _ = subdivide_tracked(tris, verts, uvs, fraction * diag)
    return tris, uvs
