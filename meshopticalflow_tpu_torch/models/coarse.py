"""Two-level geometric coarse spaces for the flow and smoothing solves.

A jax-free copy of meshopticalflow_tpu/models/coarse.py (tests/test_torch_host.py
pins the source). The host arithmetic is unchanged; the handles hold torch
tensors on an explicit device where the reference holds (lazily uploaded)
jax arrays, plus the solvers' static operators, built once per problem
(flow/pipeline.py attach_coarse_space).

The fine mesh comes from midpoint subdivision of the input mesh;
subdivide_tracked records, for every fine triangle, its ROOT coarse triangle
and the barycentric coordinates of its corners there. From that, a coarse
space for each vector-field basis follows in closed form:

  * Whitney: the coarse Whitney 1-form is affine, so its integral along a
    straight fine edge is exact by the midpoint rule: P0[e, k] is the coarse
    form W_k at the fine edge midpoint dotted with the fine edge vector;
  * Conformal: hat interpolation of the potentials at fine vertices (one
    half of the basis with ``divergence_free``);
  * Connection: the chart Jacobian J_t = [b1-b0 | b2-b0] of the fine
    triangle inside its parent maps coarse chart vectors to fine chart
    vectors by J_t^{-1}.

The composed prolongation Q = P_fine @ P0 has the per-triangle
fixed-fan-in structure of a basis, so the coarse Galerkin system
A0 = P0^T A P0 = Q^T D Q + lambda * (P0^T S P0) is assembled on the device
by the same machinery as the fine one (models.base).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from meshopticalflow_tpu_torch.config import FlowConfig, VectorFieldMode
from meshopticalflow_tpu_torch.geometry.mesh import HAT_GRADS, HostMesh
from meshopticalflow_tpu_torch.models.base import (BasisDevice, BasisHost, build_basis,
                                                   finalize_basis)


def _torch_dtype(config) -> torch.dtype:
    return torch.float64 if config.dtype == "float64" else torch.float32


def _dev(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)


@dataclasses.dataclass
class CoarseSpace:
    """Host + device handles of the coarse level."""

    coarse_host: BasisHost          # composed (fine-triangle) data structure
    coarse_dev: BasisDevice         # device system with Galerkin S0
    p0: sp.csr_matrix               # (n_fine, n_coarse) coefficient transfer
    p0_idx: np.ndarray              # (n_fine, K0) padded gather form of p0
    p0_wt: np.ndarray
    # problem-lifetime solver handle (flow/pipeline.py attach_coarse_space):
    transfer: object = None         # solvers.twolevel.Transfer of p0


def _hat(bary: np.ndarray) -> np.ndarray:
    """(..., 3) hat-function values at chart points (..., 2)."""
    return np.stack([1.0 - bary[..., 0] - bary[..., 1], bary[..., 0], bary[..., 1]], -1)


def build_coarse_space(
    config: FlowConfig,
    fine_mesh: HostMesh,
    fine_host: BasisHost,
    coarse_mesh: HostMesh,
    parent: np.ndarray,    # (T_f,)
    bary: np.ndarray,      # (T_f, 3, 2)
    device="cpu",
) -> CoarseSpace:
    mode = VectorFieldMode(config.vf_mode)
    t_f = fine_mesh.n_triangles
    coarse_host_native, _ = build_basis(coarse_mesh, config)
    n_c = coarse_host_native.n_coeffs
    n_f = fine_host.n_coeffs
    parent = np.asarray(parent, np.int64)
    bary = np.asarray(bary, np.float64)

    if mode == VectorFieldMode.WHITNEY:
        from meshopticalflow_tpu_torch.models.whitney import edge_reduction as er
        red_c, sign_c, _ = er(coarse_mesh.opp)
        red_f, sign_f, expanded = er(fine_mesh.opp)
        t = expanded // 3
        j = expanded % 3
        tau = parent[t]
        p1 = bary[t, (j + 1) % 3]
        p2 = bary[t, (j + 2) % 3]
        m = (p1 + p2) / 2.0
        d = p2 - p1
        lam = _hat(m)
        gd = d @ HAT_GRADS.T
        rows, cols, vals = [], [], []
        for k in range(3):
            k1, k2 = (k + 1) % 3, (k + 2) % 3
            w = lam[:, k1] * gd[:, k2] - lam[:, k2] * gd[:, k1]
            rows.append(np.arange(n_f))
            cols.append(red_c[3 * tau + k])
            vals.append(w * sign_c[3 * tau + k])
        p0 = sp.coo_matrix((np.concatenate(vals),
                            (np.concatenate(rows), np.concatenate(cols))),
                           shape=(n_f, n_c)).tocsr()
    elif mode == VectorFieldMode.CONFORMAL:
        v_f = fine_mesh.n_vertices
        v_c = coarse_mesh.n_vertices
        # One (triangle, corner) witness per fine vertex.
        first_t = np.full(v_f, -1, np.int64)
        first_c = np.zeros(v_f, np.int64)
        tri = fine_mesh.triangles.astype(np.int64)
        for c in range(2, -1, -1):
            first_t[tri[:, c]] = np.arange(t_f)
            first_c[tri[:, c]] = c
        assert (first_t >= 0).all()
        b_v = bary[first_t, first_c]               # (V_f, 2)
        lam = _hat(b_v)                            # (V_f, 3)
        tau = parent[first_t]
        ctri = coarse_mesh.triangles.astype(np.int64)[tau]   # (V_f, 3)
        rows = np.repeat(np.arange(v_f), 3)
        cols = ctri.ravel()
        vals = lam.ravel()
        half = sp.coo_matrix((vals, (rows, cols)), shape=(v_f, v_c)).tocsr()
        # --divFree keeps only the rotated-gradient half; hat interpolation
        # of the potentials transfers identically on the half-basis.
        p0 = half if config.divergence_free else sp.block_diag([half, half],
                                                               format="csr")
    else:  # CONNECTION
        jac = np.stack([bary[:, 1] - bary[:, 0], bary[:, 2] - bary[:, 0]], axis=-1)
        jac_inv = np.linalg.inv(jac)               # (T_f, 2, 2)
        rows = (2 * np.arange(t_f, dtype=np.int64)[:, None, None]
                + np.arange(2)[None, :, None] + np.zeros((1, 1, 2), np.int64)).ravel()
        cols = (2 * parent[:, None, None] + np.zeros((1, 2, 1), np.int64)
                + np.arange(2)[None, None, :]).ravel()
        p0 = sp.coo_matrix((jac_inv.ravel(), (rows, cols)), shape=(n_f, n_c)).tocsr()

    # Galerkin coarse smoothness.
    s0 = (p0.T @ fine_host.smooth @ p0).tocsr()

    # Composed per-fine-triangle weights Q = P_fine P0, aligned to the coarse
    # slot order p_idx_c[tau].
    k_f = fine_host.p_idx.shape[1]
    k_c = coarse_host_native.p_idx.shape[1]
    tau_of_t = parent
    comp_idx = coarse_host_native.p_idx[tau_of_t]            # (T_f, K_c)
    # rho[t, j, k0] = P0[fine coeff (t,j), coarse slot k0 of tau]
    p0_csr = p0.tocsr()
    fine_ids = fine_host.p_idx                                # (T_f, K_f)
    rho = np.zeros((t_f, k_f, k_c))
    # Extract P0 rows (<= K_c entries each, all within tau's slots).
    indptr, indices, data = p0_csr.indptr, p0_csr.indices, p0_csr.data
    # Build a dense-by-slot lookup per (t, j).
    for jf in range(k_f):
        fid = fine_ids[:, jf]
        starts, ends = indptr[fid], indptr[fid + 1]
        max_nnz = int((ends - starts).max()) if len(fid) else 0
        for o in range(max_nnz):
            pos = starts + o
            valid = pos < ends
            col = np.where(valid, indices[np.minimum(pos, len(indices) - 1)], -1)
            val = np.where(valid, data[np.minimum(pos, len(data) - 1)], 0.0)
            # locate col within comp_idx[t] (K_c slots)
            hit = comp_idx == col[:, None]                    # (T_f, K_c)
            k0 = np.argmax(hit, axis=1)
            ok = valid & hit.any(axis=1)
            rho[np.arange(t_f)[ok], jf, k0[ok]] += val[ok]
    comp_wt = np.einsum("taj,tjk->tak", fine_host.p_wt, rho)  # (T_f, 2, K_c)

    coarse_host = BasisHost("coarse-" + fine_host.name, n_c, comp_idx, comp_wt, s0)
    coarse_dev = finalize_basis(coarse_host, _torch_dtype(config), device)

    # Padded gather form of P0 for transfers.
    k0_max = int(np.diff(p0_csr.indptr).max())
    p0_idx = np.zeros((n_f, k0_max), np.int64)
    p0_wt = np.zeros((n_f, k0_max), np.float64)
    nnz = np.diff(p0_csr.indptr)
    rr = np.repeat(np.arange(n_f), nnz)
    ss = np.arange(p0_csr.nnz) - np.repeat(p0_csr.indptr[:-1], nnz)
    p0_idx[rr, ss] = p0_csr.indices
    p0_wt[rr, ss] = p0_csr.data
    return CoarseSpace(coarse_host, coarse_dev, p0_csr, p0_idx, p0_wt)


@dataclasses.dataclass
class VertexCoarse:
    """Two-level coarse space for the scalar (vertex) smoothing solves."""

    cols0: torch.Tensor       # (V0, W0) int32 shared ELL pattern of M0, K0
    m0_vals: torch.Tensor
    k0_vals: torch.Tensor
    p0_idx: torch.Tensor      # (V_f, 3) int32 hat-interpolation transfer
    p0_wt: torch.Tensor
    m0_csr: object = None     # host Galerkin operators (for deeper levels)
    k0_csr: object = None
    # problem-lifetime solver handles (flow/pipeline.py attach_coarse_space):
    mg_pack: object = None    # solvers.mg.MGPack
    c1_band: object = None    # solvers.mg.BandedC1
    transfer: object = None   # solvers.twolevel.Transfer of the hat interpolation


def build_vertex_coarse(config, fine_mesh: HostMesh, coarse_mesh: HostMesh,
                        parent: np.ndarray, bary: np.ndarray,
                        device="cpu") -> VertexCoarse:
    """Galerkin coarse mass/stiffness on the pre-subdivision mesh with the
    hat-interpolation transfer (for FlowData::smoothSignal solves)."""
    from meshopticalflow_tpu_torch.ops.assemble import scalar_mass_csr, scalar_stiffness_csr
    from meshopticalflow_tpu_torch.ops.ell import coo_slot_map, ell_from_scipy

    parent = np.asarray(parent, np.int64)
    bary = np.asarray(bary, np.float64)
    t_f = fine_mesh.n_triangles
    v_f = fine_mesh.n_vertices
    v_c = coarse_mesh.n_vertices
    # One (triangle, corner) witness per fine vertex -> hat weights.
    first_t = np.full(v_f, -1, np.int64)
    first_c = np.zeros(v_f, np.int64)
    tri = fine_mesh.triangles.astype(np.int64)
    for c in range(2, -1, -1):
        first_t[tri[:, c]] = np.arange(t_f)
        first_c[tri[:, c]] = c
    b_v = bary[first_t, first_c]
    lam = _hat(b_v)
    tau = parent[first_t]
    ctri = coarse_mesh.triangles.astype(np.int64)[tau]
    p0 = sp.coo_matrix((lam.ravel(), (np.repeat(np.arange(v_f), 3), ctri.ravel())),
                       shape=(v_f, v_c)).tocsr()

    m_f = scalar_mass_csr(fine_mesh, lump=False)
    k_f = scalar_stiffness_csr(fine_mesh)
    m0 = (p0.T @ m_f @ p0).tocsr()
    k0 = (p0.T @ k_f @ p0).tocsr()
    union = (m0 + k0).tocsr()
    ell = ell_from_scipy(union)

    def fill(csr):
        coo = csr.tocoo()
        slots = coo_slot_map(ell.cols, coo.row, coo.col)
        vals = np.zeros(ell.cols.size, np.float64)
        np.add.at(vals, slots, coo.data)
        return vals.reshape(ell.cols.shape)

    dtype = _torch_dtype(config)
    return VertexCoarse(
        cols0=_dev(ell.cols, torch.int32, device),
        m0_vals=_dev(fill(m0), dtype, device),
        k0_vals=_dev(fill(k0), dtype, device),
        p0_idx=_dev(ctri, torch.int32, device),
        p0_wt=_dev(lam, dtype, device),
        m0_csr=m0,
        k0_csr=k0,
    )


@dataclasses.dataclass
class PatchLevel:
    """Third (densest) multigrid level for the flow basis (models/patches.py),
    read by the three-level cycles: solvers/mg3.py, and the fallback of
    solvers/mg.py after a banded c1 breakdown. Whitney only."""

    q2_idx: torch.Tensor      # (T_f, K2) int64 composed fine-triangle gather
    q2_wt: torch.Tensor       # (T_f, 2, K2)
    s2_dense: torch.Tensor    # (n2, n2) Galerkin smoothness, dense
    p12_idx: np.ndarray       # (n1, K12) coarse->patch transfer (host; the
    p12_wt: np.ndarray        #   MG pack holds it as ELL operators)
    # problem-lifetime solver handles (flow/pipeline.py attach_coarse_space):
    mg_pack: object = None    # solvers.mg.MGPack
    c1_band: object = None    # solvers.mg.BandedC1
    transfer: object = None   # solvers.twolevel.Transfer of p12 (solvers/mg3.py)


@dataclasses.dataclass
class VertexPatchLevel:
    """Third multigrid level for the scalar smoothing solves."""

    m2_dense: torch.Tensor
    k2_dense: torch.Tensor
    p12_idx: np.ndarray
    p12_wt: np.ndarray
    transfer: object = None   # solvers.twolevel.Transfer of p12 (solvers/mg3.py)


def _csr_to_padded(p_csr):
    import numpy as _np
    n = p_csr.shape[0]
    k = int(_np.diff(p_csr.indptr).max())
    idx = _np.zeros((n, k), _np.int64)
    wt = _np.zeros((n, k))
    nnz = _np.diff(p_csr.indptr)
    rr = _np.repeat(_np.arange(n), nnz)
    ss = _np.arange(p_csr.nnz) - _np.repeat(p_csr.indptr[:-1], nnz)
    idx[rr, ss] = p_csr.indices
    wt[rr, ss] = p_csr.data
    return idx, wt


def build_patch_level(config, coarse_mesh: HostMesh, cs: CoarseSpace,
                      target_size: int = 12, device="cpu"):
    """Patch-aggregated coarsest level for the Whitney flow system: BFS
    patches of ``target_size`` coarse faces, 2 DoFs each, with one
    smoothed-aggregation pass on the transfer (p2 <- p2 - 0.66 D^-1 S0 p2).
    Returns (PatchLevel, patch_of_face)."""
    from meshopticalflow_tpu_torch.models.patches import (
        cluster_faces, compose_gather_rows, patch_transports, whitney_patch_p2)

    patch = cluster_faces(coarse_mesh, target_size)
    roots, l_root = patch_transports(coarse_mesh, patch)
    p2 = whitney_patch_p2(coarse_mesh, patch, l_root)        # (n1, n2)
    s0 = cs.coarse_host.smooth.tocsr()
    d0 = np.asarray(s0.diagonal())
    d0[d0 == 0] = 1.0
    p2 = (p2 - 0.66 * sp.diags(1.0 / d0) @ (s0 @ p2)).tocsr()
    s2 = np.asarray((p2.T @ cs.coarse_host.smooth @ p2).todense())
    q2_idx, q2_wt = compose_gather_rows(cs.coarse_host.p_idx, cs.coarse_host.p_wt, p2)
    p12_idx, p12_wt = _csr_to_padded(p2)
    dtype = _torch_dtype(config)
    return PatchLevel(
        q2_idx=_dev(q2_idx, torch.int64, device),
        q2_wt=_dev(q2_wt, dtype, device),
        s2_dense=_dev(s2, dtype, device),
        p12_idx=p12_idx,
        p12_wt=p12_wt,
    ), patch


def build_vertex_patch_level_from(config, m0_csr, k0_csr, coarse_mesh: HostMesh,
                                  patch: np.ndarray, device="cpu") -> VertexPatchLevel:
    from meshopticalflow_tpu_torch.models.patches import vertex_patch_p2

    p2v = vertex_patch_p2(coarse_mesh, patch)
    m2 = np.asarray((p2v.T @ m0_csr @ p2v).todense())
    k2 = np.asarray((p2v.T @ k0_csr @ p2v).todense())
    p12_idx, p12_wt = _csr_to_padded(p2v)
    dtype = _torch_dtype(config)
    return VertexPatchLevel(
        m2_dense=_dev(m2, dtype, device),
        k2_dense=_dev(k2, dtype, device),
        p12_idx=p12_idx,
        p12_wt=p12_wt,
    )
