"""The port's two- and three-level multigrid solvers, and the bfloat16 coarse
panels, against the reference package's solvers.

* ``TwoLevelSolver`` (solvers/twolevel.py) against the reference's on the
  flow systems of the subdivided sphere (tests/test_coarse.py:23-37) in all
  three bases, one rhs, and on the 6-column vertex smoothing system.
* ``ThreeLevelSolver`` (solvers/mg3.py) against the reference's on the
  Whitney flow system (the only basis with a patch level) and the 6-column
  smoothing system.
  Gates: in float64 equal iteration counts and solutions within 1e-10
  relative; in float32 iterations within 2 and solutions within 1e-4. Both
  packages solve the same system values; the port's transfers are padded-ELL
  SpMVs (the plain versions on the CPU), the reference's gathers and
  segment sums.
* ``MG3Solver(c1_bf16=True)`` against ``PallasMG3Solver(c1_bf16=True)`` in
  interpret mode, at the margins of tests/test_torch_mg.py.
"""

import functools
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from meshopticalflow_tpu.config import FlowConfig as JaxFlowConfig
from meshopticalflow_tpu.flow.signal import _smooth_system, make_smoothing_operators
from meshopticalflow_tpu.geometry.mesh import build_mesh
from meshopticalflow_tpu.geometry.subdivide import subdivide_tracked
from meshopticalflow_tpu.models import base as j_base
from meshopticalflow_tpu.models.coarse import (build_coarse_space, build_patch_level,
                                               build_vertex_coarse,
                                               build_vertex_patch_level_from)
from meshopticalflow_tpu.solvers import pallas_mg as pm
from meshopticalflow_tpu.solvers.mg3 import ThreeLevelSolver as JaxThreeLevel
from meshopticalflow_tpu.solvers.twolevel import TwoLevelSolver as JaxTwoLevel
from meshopticalflow_tpu_torch.solvers import mg
from meshopticalflow_tpu_torch.solvers.mg3 import ThreeLevelSolver
from meshopticalflow_tpu_torch.solvers.twolevel import (TwoLevelSolver, build_transfer,
                                                        padded_to_csr)
from tests.conftest import make_sphere_mesh
from tests.test_torch_mg import _sphere_system

# One intra-op thread: torch's CPU reductions then sum in one order on every
# machine and under any number of test workers.
torch.set_num_threads(1)

GATES = {"float64": (0, 1e-10), "float32": (2, 1e-4)}   # iterations, solution
# (tol, max_iters) per basis, tests/test_coarse.py:109-110: the conformal
# coarse system is singular (constant potentials) and its cycle stalls
# near 1e-6, so it and the connection cycle get looser budgets.
BUDGETS = {0: (1e-9, 45), 1: (1e-5, 150), 2: (1e-5, 150)}


def _t(a, dtype=None):
    t = torch.as_tensor(np.array(a))
    return t if dtype is None else t.to(dtype)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _hierarchy(vf_mode: int, dtype: str):
    """Subdivided sphere (tests/test_coarse.py:26-37), the reference's fine
    basis, coarse space and (Whitney) patch level, a random flow system and
    the vertex smoothing system with its hierarchy."""
    rng = np.random.default_rng(3)
    tris_c, verts_c = make_sphere_mesh(1)
    tris_f, verts_f, _, parent, bary = subdivide_tracked(tris_c, verts_c, None, 0.28)
    fine, coarse = build_mesh(tris_f, vertices=verts_f), build_mesh(tris_c, vertices=verts_c)
    cfg = JaxFlowConfig(vf_mode=vf_mode, dtype=dtype, artifact_cache=False)
    jd = jnp.dtype(dtype)
    host, dev = j_base.build_basis(fine, cfg)
    cs = build_coarse_space(cfg, fine, host, coarse, parent, bary)
    a = rng.normal(size=(fine.n_triangles, 2, 2)) * 0.3
    d_blocks = jnp.asarray(np.einsum("tak,tbk->tab", a, a), jd)
    rhs_t = jnp.asarray(rng.normal(size=(fine.n_triangles, 2)), jd)
    lam = jnp.asarray(1e-3, jd)
    sys_vals, _, rhs, diag, scale = j_base.build_flow_system(dev, d_blocks, rhs_t, lam)
    c_vals, c_diag = j_base.coarse_system_vals(cs.coarse_dev, d_blocks, scale, lam)
    out = dict(cs=cs, dev=dev, cols=dev.ell_cols, sys=(sys_vals, diag), rhs=rhs,
               c_vals=c_vals, c_diag=c_diag, dtype=getattr(torch, dtype))
    vc = build_vertex_coarse(cfg, fine, coarse, parent, bary)
    ops = make_smoothing_operators(fine, jd)
    sig = jnp.asarray(rng.uniform(0, 255, (fine.n_vertices, 6)), jd)
    w = jnp.asarray(3e-3, jd)
    v_sys, v_b, v_diag = _smooth_system(ops, sig, w)
    v_c_vals = vc.m0_vals + w * vc.k0_vals
    cols0 = np.asarray(vc.cols0)
    slot0 = np.argmax(cols0 == np.arange(cols0.shape[0])[:, None], axis=1)
    out.update(vc=vc, v_cols=ops.cols, v_sys=(v_sys, v_diag), v_b=v_b, v_x0=sig,
               v_c_vals=v_c_vals,
               v_c_diag=np.take_along_axis(np.asarray(v_c_vals), slot0[:, None], 1)[:, 0])
    if vf_mode == 0:
        patch, patch_ids = build_patch_level(cfg, coarse, cs, target_size=4)
        vp = build_vertex_patch_level_from(cfg, vc.m0_csr, vc.k0_csr, coarse, patch_ids)
        out.update(patch=patch, vp=vp,
                   a2=j_base.patch_system_dense(patch.q2_idx, patch.q2_wt, d_blocks, scale,
                                                lam, patch.s2_dense),
                   v_a2=vp.m2_dense + w * vp.k2_dense)
    return out


_hierarchy = functools.lru_cache(maxsize=None)(_hierarchy)


def _assert_parity(h, xj, sj, xt, st, field=False):
    """Iterations and solutions at the dtype's gates; ``field`` compares the
    prolonged flow fields P x, which the conformal null space (constant
    potentials, free in x) does not reach."""
    it_margin, sol_tol = GATES[str(h["dtype"]).removeprefix("torch.")]
    assert abs(st.iterations - int(sj.iterations)) <= it_margin, \
        (int(sj.iterations), st.iterations)
    if field:
        xt, xj = (j_base.prolong(h["dev"], jnp.asarray(x)) for x in (xt.numpy(), xj))
    assert _rel(np.asarray(xt), np.asarray(xj)) <= sol_tol, \
        _rel(np.asarray(xt), np.asarray(xj))


# float32 conformal is left out: the reference's own float32 cycle diverges
# on the singular conformal system (relative residual 99 after 150 iterations)
@pytest.mark.parametrize("mode,dtype", [(0, "float64"), (1, "float64"), (2, "float64"),
                                        (0, "float32"), (2, "float32")])
def test_two_level_flow_matches_reference(mode, dtype):
    h = _hierarchy(mode, dtype)
    cs = h["cs"]
    js = JaxTwoLevel(h["cols"], *h["sys"], cs.coarse_dev.ell_cols, h["c_vals"],
                     cs.p0_idx_dev, cs.p0_wt_dev)
    ts = TwoLevelSolver(_t(h["cols"]), *(_t(a) for a in h["sys"]),
                        _t(cs.coarse_dev.ell_cols), _t(h["c_vals"]),
                        build_transfer(cs.p0, h["dtype"], "cpu"))
    name = next(k for k in ("whitney", "conformal", "connection") if k in cs.coarse_host.name)
    tol, max_it = BUDGETS[("whitney", "conformal", "connection").index(name)]
    xj, sj = js.solve(h["rhs"], tol=tol, max_iters=max_it)
    xt, st = ts.solve(_t(h["rhs"]), tol=tol, max_iters=max_it)
    _assert_parity(h, xj, sj, xt, st, field=True)
    assert st.rel_residual < 50 * tol
    assert ts.gb_per_iter > 0 and ts.factor_seconds >= 0


def _vertex_transfer(h):
    vc = h["vc"]
    return build_transfer(padded_to_csr(vc.p0_idx, vc.p0_wt, vc.cols0.shape[0]),
                          h["dtype"], "cpu")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_two_level_smoothing_matches_reference(dtype):
    """The 6-column smoothing system (the cycle of the non-Whitney bases)."""
    h = _hierarchy(0, dtype)
    vc = h["vc"]
    js = JaxTwoLevel(h["v_cols"], *h["v_sys"], vc.cols0, h["v_c_vals"], vc.p0_idx, vc.p0_wt)
    ts = TwoLevelSolver(_t(h["v_cols"]), *(_t(a) for a in h["v_sys"]), _t(vc.cols0),
                        _t(h["v_c_vals"]), _vertex_transfer(h))
    xj, sj = js.solve(h["v_b"], x0=h["v_x0"], tol=1e-7, max_iters=100)
    xt, st = ts.solve(_t(h["v_b"]), x0=_t(h["v_x0"]), tol=1e-7, max_iters=100)
    assert xt.shape == (h["v_b"].shape[0], 6)
    _assert_parity(h, xj, sj, xt, st)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_three_level_matches_reference(dtype):
    """Flow (nu 4, as the reference's flow solve) and 6-column smoothing."""
    h = _hierarchy(0, dtype)
    cs, patch, vc, vp = h["cs"], h["patch"], h["vc"], h["vp"]
    n2, vn2 = h["a2"].shape[0], h["v_a2"].shape[0]
    js = JaxThreeLevel(h["cols"], *h["sys"], cs.coarse_dev.ell_cols, h["c_vals"],
                       cs.p0_idx_dev, cs.p0_wt_dev, h["a2"], patch.p12_idx, patch.p12_wt,
                       nu=4)
    ts = ThreeLevelSolver(_t(h["cols"]), *(_t(a) for a in h["sys"]),
                          _t(cs.coarse_dev.ell_cols), _t(h["c_vals"]), _t(h["c_diag"]),
                          build_transfer(cs.p0, h["dtype"], "cpu"), _t(h["a2"]),
                          build_transfer(padded_to_csr(patch.p12_idx, patch.p12_wt, n2),
                                         h["dtype"], "cpu"), nu=4)
    xj, sj = js.solve(h["rhs"], tol=1e-6, max_iters=120)
    xt, st = ts.solve(_t(h["rhs"]), tol=1e-6, max_iters=120)
    _assert_parity(h, xj, sj, xt, st)
    assert st.iterations % 8 == 0 and ts.gb_per_iter > 0
    js = JaxThreeLevel(h["v_cols"], *h["v_sys"], vc.cols0, h["v_c_vals"], vc.p0_idx,
                       vc.p0_wt, h["v_a2"], vp.p12_idx, vp.p12_wt)
    ts = ThreeLevelSolver(_t(h["v_cols"]), *(_t(a) for a in h["v_sys"]), _t(vc.cols0),
                          _t(h["v_c_vals"]), _t(h["v_c_diag"]), _vertex_transfer(h),
                          _t(h["v_a2"]),
                          build_transfer(padded_to_csr(vp.p12_idx, vp.p12_wt, vn2),
                                         h["dtype"], "cpu"))
    xj, sj = js.solve(h["v_b"], x0=h["v_x0"], tol=1e-7, max_iters=100)
    xt, st = ts.solve(_t(h["v_b"]), x0=_t(h["v_x0"]), tol=1e-7, max_iters=100)
    _assert_parity(h, xj, sj, xt, st)


def test_transfer_is_the_matrix_and_its_transpose():
    rng = np.random.default_rng(5)
    p = sp.random(40, 9, density=0.2, random_state=2, format="csr")
    t = build_transfer(p, torch.float64, "cpu")
    x, y = rng.normal(size=9), rng.normal(size=(40, 3))
    np.testing.assert_allclose(t.p.apply(torch.as_tensor(x)).numpy(), p @ x, rtol=1e-14)
    np.testing.assert_allclose(t.pt.apply(torch.as_tensor(y)).numpy(), p.T @ y,
                               rtol=1e-13, atol=1e-14)
    with pytest.raises(TypeError, match="working dtype"):
        TwoLevelSolver(torch.zeros((40, 1), dtype=torch.int32), torch.ones((40, 1)),
                       torch.ones(40), torch.zeros((9, 1), dtype=torch.int32),
                       torch.ones((9, 1)), t)


@pytest.fixture(scope="module")
def sphere():
    return _sphere_system()


def test_bf16_coarse_panels_match_pallas(sphere):
    """mg_c1_bf16: the exact-c1 cycle with bfloat16 solve panels."""
    jband = pm.build_c1_band(sphere["jpack"], sphere["c1_cols"], nb=32)
    tband = mg.build_c1_band(sphere["c1_cols"], nb=32)
    js = pm.PallasMG3Solver(sphere["jpack"], *sphere["jax"], c1_band=jband, c1_bf16=True)
    xj, sj = js.solve(sphere["rhs"], tol=1e-6, max_iters=200, chunk=2)
    ts = mg.MG3Solver(sphere["tpack"], *sphere["torch"], c1_band=tband, c1_bf16=True)
    xt, st = ts.solve(_t(sphere["rhs"]), tol=1e-6, max_iters=200, chunk=2)
    assert ts.c1_dinv.dtype == ts.c1_pbelow.dtype == torch.bfloat16
    assert _rel(xt.numpy(), np.asarray(xj)) < 1e-4
    assert abs(st.iterations - int(sj.iterations)) <= 2, (int(sj.iterations), st.iterations)
    assert st.rel_residual < 1e-5
    full = mg.MG3Solver(sphere["tpack"], *sphere["torch"], c1_band=tband)
    assert ts.gb_per_iter < full.gb_per_iter


# -- the solvers through the pipeline ------------------------------------------

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")

# Texture runs on the 64^2 cube (cA/cB.png, --eLength 0.08, float64,
# multigrid on), each against the JAX package's run of the same config:
# (config, alignment-error tolerance per level, flow_iters margin or None).
# * conformal: the two-level cycle on the singular conformal coarse system
#   stalls and refinement rounds restart it, so iteration counts wander
#   (JAX vs port, my CPU run: 319 vs 199 at one level) while both reach
#   flow_refine_tol; no iteration gate.
# * connection at vfSmooth 1: at the default weight (1e4) neither package's
#   two-level cycle converges (flow_res ~0.1 at every level on this cube), so
#   the trajectories part after level 0; the default weight is held at level
#   0 ("connection-default").
# * whitney-2level: flow_mg_levels=2 with the xla smoothing cycle, the
#   solvers the JAX package runs on the CPU for that config.
TEXTURE_RUNS = {
    "conformal": (dict(vf_mode=1), 1e-6, None),
    "conformal-divfree": (dict(vf_mode=1, divergence_free=True), 1e-6, 2),
    "connection": (dict(vf_mode=2, vf_smooth_weight=1.0), 1e-6, 2),
    "connection-default": (dict(vf_mode=2, levels=1), 1e-12, 0),
    "whitney-2level": (dict(flow_mg_levels=2, flow_backend="xla"), 1e-6, 2),
    "whitney-xla": (dict(flow_backend="xla"), 1e-6, 2),
}


@pytest.mark.parametrize("name", sorted(TEXTURE_RUNS))
def test_texture_run_matches_reference(name):
    from meshopticalflow_tpu.flow import pipeline as j_pipeline
    from meshopticalflow_tpu_torch.config import FlowConfig
    from meshopticalflow_tpu_torch.flow import pipeline as t_pipeline

    kw, align_tol, iter_margin = TEXTURE_RUNS[name]
    kw = dict(dtype="float64", subdivide_edge_length=0.08, **kw)
    mesh = os.path.join(GOLD, "cube.ply")
    paths = (os.path.join(GOLD, "cA.png"), os.path.join(GOLD, "cB.png"))
    jp = j_pipeline.FlowProblem.from_texture_inputs(
        mesh, paths, JaxFlowConfig(artifact_cache=False, **kw))
    ref = jp.run()
    tp = t_pipeline.FlowProblem.from_texture_inputs(
        mesh, paths, FlowConfig(artifact_cache=False, **kw), device="cpu")
    ours = tp.run()
    whitney = kw.get("vf_mode", 0) == 0
    assert (tp.hier.patch is not None) == whitney
    assert tp.hier.flow_kind == ("xla" if name == "whitney-xla" else "twolevel")
    assert tp.hier.smooth_kind == ("xla" if whitney else "twolevel")
    assert len(ours.metrics) == len(ref.metrics) == tp.config.levels
    for m_t, m_j in zip(ours.metrics, ref.metrics):
        err = abs(m_t["alignment_error"] - m_j["alignment_error"]) / abs(m_j["alignment_error"])
        assert err <= align_tol, (m_t["level"], err)
        if iter_margin is not None:
            assert abs(m_t["flow_iters"] - m_j["flow_iters"]) <= iter_margin, \
                (m_t["level"], m_t["flow_iters"], m_j["flow_iters"])
        if name == "connection-default":
            assert abs(m_t["flow_res"] / m_j["flow_res"] - 1) < 0.05
        else:
            assert m_t["flow_res"] <= 10 * tp.config.flow_refine_tol
        assert m_t["flow_gb_per_iter"] > 0 and m_t["smooth_gb_per_iter"] > 0


@pytest.mark.parametrize("kw", [dict(flow_backend="xla"), dict(flow_mg_levels=2),
                                dict(mg_c1_bf16=True)],
                         ids=["xla", "2level", "c1_bf16"])
def test_golden_cube256_through_other_solvers(tmp_path, kw):
    """ref_cube256.png at tests/test_golden.py:113-138's thresholds through
    the xla backend, the two-level flow solve and the bf16 coarse panels."""
    from meshopticalflow_tpu_torch.config import FlowConfig
    from meshopticalflow_tpu_torch.flow import pipeline as t_pipeline
    from meshopticalflow_tpu_torch.io.png import read_png_rgb

    cfg = FlowConfig(dtype="float64", subdivide_edge_length=0.06, artifact_cache=False, **kw)
    prob = t_pipeline.FlowProblem.from_texture_inputs(
        os.path.join(GOLD, "cube.ply"),
        (os.path.join(GOLD, "mA.png"), os.path.join(GOLD, "mB.png")), cfg, device="cpu")
    prob.run()
    out = str(tmp_path / "out.png")
    prob.write_output(out)
    ours = read_png_rgb(out).astype(float)
    ref = read_png_rgb(os.path.join(GOLD, "ref_cube256.png")).astype(float)
    rmse = float(np.sqrt(((ours - ref) ** 2).mean()))
    assert rmse < 2.2
    assert float((ours == ref).all(-1).mean()) > 0.97
    assert float((np.abs(ours - ref) <= 1).all(-1).mean()) > 0.995
