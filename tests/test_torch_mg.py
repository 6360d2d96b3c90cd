"""The port's multigrid solvers against the reference package's Pallas ones.

solvers/mg.py (MG3Solver, MG3MultiSolver) runs the cycles of
meshopticalflow_tpu/solvers/pallas_mg.py on the padded-ELL SpMV kernels; on
CPU tensors the kernels take their plain versions. The reference solvers run
their Pallas kernels in interpret mode, on the small-sphere systems of
tests/test_pallas.py. Gates (float32 on both sides, with bf16 sweeps and
transfers): the same solution to 1e-4 relative, iteration counts within 2,
and the requested relative residual. The two sum in other orders (tiles vs
ELL rows) and seed the Chebyshev power iterations in other orders (the
reference's permuted tile order vs the natural order), hence the margins.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from meshopticalflow_tpu.config import FlowConfig as JaxFlowConfig
from meshopticalflow_tpu.geometry.mesh import build_mesh as j_build_mesh
from meshopticalflow_tpu.geometry.subdivide import subdivide_tracked
from meshopticalflow_tpu.models import base as j_base
from meshopticalflow_tpu.models.coarse import (build_coarse_space, build_patch_level,
                                               build_vertex_coarse,
                                               build_vertex_patch_level_from)
from meshopticalflow_tpu.solvers import pallas_mg as pm
from meshopticalflow_tpu_torch.flow import pipeline as t_pipeline
from meshopticalflow_tpu_torch.models import base as t_base
from meshopticalflow_tpu_torch.solvers import mg
from tests.conftest import make_sphere_mesh

# One intra-op thread: torch's CPU reductions then sum in one order on every
# machine and under any number of test workers.
torch.set_num_threads(1)

SOL_TOL = 1e-4
ITER_MARGIN = 2


def _t(a, dtype=None):
    t = torch.as_tensor(np.array(a))
    return t if dtype is None else t.to(dtype)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _sphere_system():
    """The flow system of tests/test_pallas.py:112-169 (small sphere, one
    subdivision pass, patch target 4), with both packages' packs."""
    rng = np.random.default_rng(0)
    tris0, verts0 = make_sphere_mesh(2)
    diag = float(np.linalg.norm(verts0.max(0) - verts0.min(0)))
    uvs = np.zeros((len(tris0), 3, 2))
    tris, verts, _, parent, bary = subdivide_tracked(tris0, verts0, uvs, 0.3 * diag)
    cfg = JaxFlowConfig(dtype="float32", dog_weight=0.0)
    fine_mesh = j_build_mesh(tris, vertices=verts)
    coarse_mesh = j_build_mesh(tris0, vertices=verts0)
    fine_host, fine_dev = j_base.build_basis(fine_mesh, cfg)
    cs = build_coarse_space(cfg, fine_mesh, fine_host, coarse_mesh, parent, bary)
    patch, _ = build_patch_level(cfg, coarse_mesh, cs, target_size=4)
    t_f = fine_mesh.n_triangles
    d = rng.normal(size=(t_f, 2, 2))
    d_blocks = jnp.asarray(np.einsum("tab,tcb->tac", d, d) + 0.3 * np.eye(2), jnp.float32)
    rhs_t = jnp.asarray(rng.normal(size=(t_f, 2)), jnp.float32)
    lam = jnp.asarray(3e-4, jnp.float32)
    sys_vals, _, rhs, fdiag, scale = j_base.build_flow_system(fine_dev, d_blocks, rhs_t, lam)
    c_vals, c_diag = j_base.coarse_system_vals(cs.coarse_dev, d_blocks, scale, lam)
    a2 = j_base.patch_system_dense(patch.q2_idx, patch.q2_wt, d_blocks, scale, lam,
                                   patch.s2_dense)
    fine_cols = np.asarray(fine_dev.ell_cols)
    c1_cols = np.asarray(cs.coarse_dev.ell_cols)
    args = (np.asarray(patch.p12_idx), np.asarray(patch.p12_wt), int(a2.shape[0]))
    jpack = pm.build_mg_pack(fine_cols, c1_cols, cs.p0, *args, interpret=True)
    tpack = mg.build_mg_pack(fine_cols, c1_cols, cs.p0, *args, dtype=torch.float32)
    return dict(jax=(sys_vals, fdiag, c_vals, c_diag, a2), rhs=rhs, jpack=jpack,
                tpack=tpack, c1_cols=c1_cols, fine_cols=fine_cols,
                torch=tuple(_t(a) for a in (sys_vals, fdiag, c_vals, c_diag, a2)))


@pytest.fixture(scope="module")
def sphere():
    return _sphere_system()


def _solve_pair(sphere, jkw, tkw, solve_kw):
    js = pm.PallasMG3Solver(sphere["jpack"], *sphere["jax"], **jkw)
    xj, sj = js.solve(sphere["rhs"], **solve_kw)
    ts = mg.MG3Solver(sphere["tpack"], *sphere["torch"], **tkw)
    xt, st = ts.solve(_t(sphere["rhs"]), **solve_kw)
    return (np.asarray(xj), int(sj.iterations), float(sj.rel_residual)), \
        (xt.numpy(), st.iterations, st.rel_residual), ts


def _assert_parity(ref, ours, tol=1e-6):
    (xj, ij, rj), (xt, it, rt) = ref, ours
    assert _rel(xt, xj) < SOL_TOL, (_rel(xt, xj), ij, it)
    assert abs(it - ij) <= ITER_MARGIN, (ij, it)
    assert rt < 10 * tol and rj < 10 * tol, (rj, rt)


@pytest.mark.parametrize("chunk,tol", [(8, 1e-6), (1, 1e-10)])
@pytest.mark.parametrize("cheb_k", [1, 4])
def test_three_level_cycle_matches_pallas(sphere, cheb_k, chunk, tol):
    """The 3-level Jacobi + patch cycle (the fallback), plain V and with the
    k=4 Chebyshev coarse solve (tests/test_pallas.py:112-182); chunk 1
    compares the iteration counts exactly where they stop."""
    kw = dict(cheb_k=cheb_k)
    ref, ours, _ = _solve_pair(sphere, kw, kw, dict(tol=tol, max_iters=200, chunk=chunk))
    _assert_parity(ref, ours, tol)


@pytest.mark.parametrize("chunk,tol", [(2, 1e-6), (1, 1e-10)])
def test_banded_exact_cycle_matches_pallas(sphere, chunk, tol):
    """The production cycle: exact banded c1 solve (tests/test_pallas.py:301-364)."""
    jband = pm.build_c1_band(sphere["jpack"], sphere["c1_cols"], nb=32)
    tband = mg.build_c1_band(sphere["c1_cols"], nb=32)
    ref, ours, ts = _solve_pair(sphere, dict(c1_band=jband), dict(c1_band=tband),
                                dict(tol=tol, max_iters=200, chunk=chunk))
    _assert_parity(ref, ours, tol)
    assert ts.c1_l_blocks is not None and 0 < ts.gb_per_iter < 1.0


def test_chebyshev_fine_smoother_matches_pallas(sphere):
    """mg_fine_cheb=2 in the exact cycle (tests/test_pallas.py:371-378)."""
    jband = pm.build_c1_band(sphere["jpack"], sphere["c1_cols"], nb=32)
    tband = mg.build_c1_band(sphere["c1_cols"], nb=32)
    ref, ours, _ = _solve_pair(sphere, dict(c1_band=jband, cheb_fine_deg=2),
                               dict(c1_band=tband, cheb_fine_deg=2),
                               dict(tol=1e-6, max_iters=200, chunk=2))
    _assert_parity(ref, ours)


def test_banded_breakdown_raises_then_falls_back(sphere):
    """A c1 factorization that fails at every shift does not raise in the
    constructor (deferred check), raises BandedBreakdownError at the first
    solve fetch and records the breakdown (tests/test_pallas.py:472-516)."""
    sys_vals, fdiag, _, _, _ = sphere["torch"]
    n1, w1 = sphere["c1_cols"].shape
    band = mg.build_c1_band(sphere["c1_cols"], nb=32)
    broken = mg.MG3Solver(sphere["tpack"], sys_vals, fdiag,
                          -torch.ones((n1, w1)), -torch.ones(n1), None, c1_band=band)
    assert broken.c1_l_blocks is not None and broken._c1_ok_dev is not None
    with pytest.raises(mg.BandedBreakdownError):
        broken.solve(_t(sphere["rhs"]), max_iters=2)
    assert broken.c1_l_blocks is None


def _vertex_problem():
    """A vertex smoothing system on the subdivided small sphere with both
    packages' hierarchies (tests/test_pallas.py:202-300, 396-456)."""
    from meshopticalflow_tpu.flow.pipeline import FlowProblem as JaxProblem

    rng = np.random.default_rng(1)
    tris0, verts0 = make_sphere_mesh(2)
    diag = float(np.linalg.norm(verts0.max(0) - verts0.min(0)))
    uvs = np.zeros((len(tris0), 3, 2))
    tris, verts, _, parent, bary = subdivide_tracked(tris0, verts0, uvs, 0.3 * diag)
    cfg = JaxFlowConfig(dtype="float32", dog_weight=0.0, artifact_cache=False)
    mesh = j_build_mesh(tris, vertices=verts)
    coarse_mesh = j_build_mesh(tris0, vertices=verts0)
    sig = rng.normal(size=(2, mesh.n_vertices, 3)) * 10 + 128
    prob = JaxProblem(cfg, mesh, sig, vertices=verts)
    vc = build_vertex_coarse(cfg, mesh, coarse_mesh, parent, bary)
    patch_ids = np.arange(coarse_mesh.n_triangles) % 5
    vp = build_vertex_patch_level_from(cfg, vc.m0_csr, vc.k0_csr, coarse_mesh, patch_ids)
    idx, wt = np.asarray(vc.p0_idx), np.asarray(vc.p0_wt, np.float64)
    v_f, k0 = idx.shape
    p0 = sp.csr_matrix((wt.ravel(), (np.repeat(np.arange(v_f), k0), idx.ravel())),
                       shape=(v_f, coarse_mesh.n_vertices))
    cols, cols0 = np.asarray(prob.arrays.smooth_ops.cols), np.asarray(vc.cols0)
    args = (cols, cols0, p0, np.asarray(vp.p12_idx), np.asarray(vp.p12_wt),
            int(vp.m2_dense.shape[0]))
    jpack = pm.build_mg_pack(*args, interpret=True)
    tpack = mg.build_mg_pack(*args, dtype=torch.float32)
    w = jnp.asarray(3e-3, jnp.float32)
    from meshopticalflow_tpu.flow.signal import _smooth_system
    sys_vals, b, fdiag = _smooth_system(prob.arrays.smooth_ops, prob.arrays.signals, w)
    c_vals = vc.m0_vals + w * vc.k0_vals
    c_diag = jnp.take_along_axis(c_vals, jnp.argmax(
        vc.cols0 == jnp.arange(cols0.shape[0])[:, None], axis=1)[:, None], axis=1)[:, 0]
    a2 = vp.m2_dense + w * vp.k2_dense
    return dict(jpack=jpack, tpack=tpack, cols0=cols0, b=b, x0=prob.arrays.signals,
                jax=(sys_vals, fdiag, c_vals, c_diag),
                torch=tuple(_t(a) for a in (sys_vals, fdiag, c_vals, c_diag)),
                a2=a2)


@pytest.fixture(scope="module")
def vertex():
    return _vertex_problem()


@pytest.mark.parametrize("coarse", ["banded", "patch"])
def test_multi_rhs_smoothing_matches_pallas(vertex, coarse):
    """PallasMG3MultiSolver on the 6-column smoothing system, exact banded
    c1 and the 3-level patch fallback."""
    if coarse == "banded":
        jkw = dict(c1_band=pm.build_c1_band(vertex["jpack"], vertex["cols0"]))
        tkw = dict(c1_band=mg.build_c1_band(vertex["cols0"]))
        ja2 = ta2 = None
    else:
        jkw = tkw = {}
        ja2, ta2 = vertex["a2"], _t(vertex["a2"])
    js = pm.PallasMG3MultiSolver(vertex["jpack"], *vertex["jax"], ja2, **jkw)
    xj, sj = js.solve(vertex["b"], x0=vertex["x0"], tol=1e-7, max_iters=100)
    ts = mg.MG3MultiSolver(vertex["tpack"], *vertex["torch"], ta2, **tkw)
    xt, st = ts.solve(_t(vertex["b"]), x0=_t(vertex["x0"]), tol=1e-7, max_iters=100)
    assert xt.shape == np.asarray(xj).shape
    for ch in range(xt.shape[1]):
        assert _rel(xt[:, ch].numpy(), np.asarray(xj)[:, ch]) < SOL_TOL, ch
    assert abs(st.iterations - int(sj.iterations)) <= ITER_MARGIN, \
        (int(sj.iterations), st.iterations)
    assert st.rel_residual < 1e-6


def test_multi_rhs_banded_breakdown_raises(vertex):
    band = mg.build_c1_band(vertex["cols0"])
    sys_vals, fdiag, c_vals, _ = vertex["torch"]
    broken = mg.MG3MultiSolver(vertex["tpack"], sys_vals, fdiag, -torch.ones_like(c_vals),
                               -torch.ones(c_vals.shape[0]), None, c1_band=band)
    with pytest.raises(mg.BandedBreakdownError):
        broken.solve(_t(vertex["b"]), max_iters=2)
    assert broken.c1_l_blocks is None


def test_flow_step_survives_banded_breakdown(monkeypatch):
    """update_optical_flow rebuilds with the dense-patch coarsest when the
    banded factorization breaks down mid-solve, and lands on the same
    refined solution (models/base.py:636-649 of the reference)."""
    from meshopticalflow_tpu_torch.config import FlowConfig

    cfg = FlowConfig(dtype="float64", subdivide_edge_length=0.3, dog_weight=0.0)
    tris0, verts0 = make_sphere_mesh(1)
    from meshopticalflow_tpu_torch.geometry.mesh import build_mesh
    from meshopticalflow_tpu_torch.geometry.subdivide import subdivide_tracked as t_sub
    diag = float(np.linalg.norm(verts0.max(0) - verts0.min(0)))
    tris, verts, _, parent, bary = t_sub(tris0, verts0, np.zeros((len(tris0), 3, 2)),
                                         0.3 * diag)
    mesh = build_mesh(tris, vertices=verts)
    rng = np.random.default_rng(2)
    sig = rng.uniform(0, 255, (2, mesh.n_vertices, 3))
    prob = t_pipeline.FlowProblem(cfg, mesh, sig, root=(tris0, verts0, parent, bary),
                                  device="cpu")
    t = mesh.n_triangles
    d = rng.normal(size=(t, 2, 2))
    d_blocks = torch.as_tensor(np.einsum("tab,tcb->tac", d, d) + 0.3 * np.eye(2))
    rhs_t = torch.as_tensor(rng.normal(size=(t, 2)))
    coeffs = torch.zeros(prob.arrays.basis.n_coeffs, dtype=torch.float64)
    kw = dict(coarse=prob.hier.coarse, patch=prob.hier.patch, mg_cheb_k=4,
              mg_coarse_exact=True)
    info = {}
    good = t_base.update_optical_flow(prob.arrays.basis, coeffs, d_blocks, rhs_t, 3e-6,
                                      solve_info=info, **kw)
    assert info["factor_s"] > 0

    real = mg._factor_c1_panels

    def broken(band, vals, diag, defer_check=False, bf16=False):
        return real(band, -torch.ones_like(vals), -torch.ones_like(diag), defer_check, bf16)

    monkeypatch.setattr(mg, "_factor_c1_panels", broken)
    fell_back = t_base.update_optical_flow(prob.arrays.basis, coeffs, d_blocks, rhs_t,
                                           3e-6, solve_info=info, **kw)
    assert info["factor_s"] == 0.0     # no banded factor on the fallback
    assert fell_back[2].rel_residual < 1e-8
    assert _rel(fell_back[3].numpy(), good[3].numpy()) < 1e-6
    # the smoothing stage falls back the same way
    out, stats, info = t_pipeline._stage_smooth(prob.arrays, 3e-3, cfg, prob.hier)
    assert info["factor_s"] == 0.0 and stats.rel_residual < cfg.cg_tol


@pytest.mark.parametrize("case", ["first", "adaptive"])
def test_adaptive_chunking_matches_reference(case):
    """_next_chunk / _update_rho(_fast) are the reference's scheduling rules."""
    rng = np.random.default_rng(3 if case == "first" else 4)
    for _ in range(200):
        r2 = float(10 ** rng.uniform(-8, 2))
        thr = float(10 ** rng.uniform(-14, -6))
        rho = None if case == "first" else float(rng.uniform(0.05, 0.99))
        fast = None if case == "first" else float(rng.uniform(0.01, rho))
        chunk = int(rng.choice([8, 16, 24]))
        assert mg._next_chunk(r2, thr, rho, chunk, fast) == \
            pm._next_chunk(r2, thr, rho, chunk, fast)
        b, a, it = float(rng.uniform(1, 2)), float(rng.uniform(0, 2)), int(rng.integers(1, 50))
        assert mg._update_rho(rho, b, a, it) == pm._update_rho(rho, b, a, it)
        assert mg._update_rho_fast(fast, b, a, it) == pm._update_rho_fast(fast, b, a, it)


@pytest.mark.parametrize("ncols", [0, 3])
def test_ell_op_refuses_wrong_length(ncols):
    """A rectangular operator (P0 shape: 5 out, 3 in) takes only x with n_in
    rows, so a P0 / P0^T mix-up raises instead of reading out of range."""
    rng = np.random.default_rng(6)
    cols = rng.integers(0, 3, (5, 2)).astype(np.int32)
    op = mg._ell_op(cols, rng.normal(size=(5, 2)), 3, torch.float64, "cpu")
    shape = (lambda n: (n, ncols)) if ncols else (lambda n: (n,))
    x = torch.as_tensor(rng.normal(size=shape(3)))
    want = torch.as_tensor(sp.csr_matrix((op.vals.numpy().ravel(), cols.ravel(),
                                          np.arange(0, 11, 2)), shape=(5, 3)) @ x.numpy())
    torch.testing.assert_close(op.apply(x), want, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="takes 3 rows"):
        op.apply(torch.zeros(shape(5), dtype=torch.float64))
