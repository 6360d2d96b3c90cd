"""The port's multifrontal direct solve (solvers/multifrontal.py) against the
reference package's and scipy.

* The host symbolic analysis (nested dissection, front structure, per-depth
  tables) is array-equal to the reference's at leaf 16 and 48.
* The float64 factor and solve against scipy's sparse direct solve
  (relative residual < 1e-11) and against the reference's ``_solve_jit``
  (1e-10 relative), on the Whitney system of tests/test_multifrontal.py.
* The semidefinite conformal grid with a 1e-9 shift under ``refine_loop``
  (< 1e-9), and the float32 factor under refinement (< 3e-9).
* ``flow_backend="mf"`` through the whole pipeline against the port's own
  multigrid run and the reference's mf run on the synthetic sphere, at the
  thresholds of tests/test_multifrontal.py:94-117 (tfield to 1e-4 of its
  scale, alignment error to 1e-5 relative); the breakdown chain (a shifted
  refactor, then the multigrid solve) on a semidefinite and an indefinite
  level system; the CLI with ``--flowBackend mf`` against the reference
  binary's cube golden (tests/test_golden.py:92's thresholds).
"""

import dataclasses
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from meshopticalflow_tpu.config import FlowConfig as JaxFlowConfig
from meshopticalflow_tpu.config import VectorFieldMode
from meshopticalflow_tpu.geometry.mesh import build_mesh as j_build_mesh
from meshopticalflow_tpu.models.base import build_basis as j_build_basis
from meshopticalflow_tpu.models.base import build_flow_system as j_build_flow_system
from meshopticalflow_tpu.solvers import multifrontal as j_mf
from meshopticalflow_tpu_torch.config import FlowConfig
from meshopticalflow_tpu_torch.flow import pipeline as t_pipeline
from meshopticalflow_tpu_torch.geometry.mesh import build_mesh as t_build_mesh
from meshopticalflow_tpu_torch.models import base as t_base
from meshopticalflow_tpu_torch.solvers import multifrontal as t_mf
from meshopticalflow_tpu_torch.solvers.refine import refine_loop
from meshopticalflow_tpu_torch.utils import devcache

from conftest import make_grid_mesh, make_sphere_mesh

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "golden")


@pytest.fixture(autouse=True)
def _artifact_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("MESHFLOW_CACHE", str(tmp_path / "artifacts"))


def _system(tris, verts, mode, seed=7, lam=1e-3):
    """tests/test_multifrontal.py:25-44's level system (float64) through the
    reference package, as numpy, with its scipy matrix and DOF positions."""
    mesh = j_build_mesh(tris, vertices=verts)
    host, dev = j_build_basis(mesh, JaxFlowConfig(vf_mode=mode, dtype="float64"))
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(mesh.n_triangles, 2, 2)) * 0.5
    d_blocks = np.einsum("tak,tbk->tab", a, a) + 1e-3 * np.eye(2)[None]
    rhs_t = rng.normal(size=(mesh.n_triangles, 2))
    sys_vals, _, rhs, _, _ = j_build_flow_system(dev, jnp.asarray(d_blocks),
                                                 jnp.asarray(rhs_t), lam)
    cols = np.asarray(dev.ell_cols)
    n, w = cols.shape
    a_host = sp.csr_matrix((np.asarray(sys_vals, np.float64).ravel(),
                            (np.repeat(np.arange(n), w), cols.astype(np.int64).ravel())),
                           shape=(n, n))
    pos = j_mf.dof_positions(tris, verts, host.p_idx, host.n_coeffs)
    return dict(cols=cols, vals=np.array(sys_vals), rhs=np.array(rhs), a=a_host,
                pos=pos, diag_slot=np.array(dev.diag_slot), p_idx=host.p_idx,
                n=host.n_coeffs, jax=(sys_vals, rhs))


@pytest.fixture(scope="module")
def sphere():
    tris, verts = make_sphere_mesh(3)
    return _system(tris, verts, VectorFieldMode.WHITNEY)


def _rel_res(a, x, b):
    return float(np.linalg.norm(a @ np.asarray(x, np.float64) - b) / np.linalg.norm(b))


def test_dof_positions_match_reference(sphere):
    tris, verts = make_sphere_mesh(3)
    ours = t_mf.dof_positions(tris, verts, sphere["p_idx"], sphere["n"])
    np.testing.assert_array_equal(ours, sphere["pos"])


@pytest.mark.parametrize("leaf", [16, 48])
def test_nd_pack_tables_match_reference(sphere, leaf):
    ref = j_mf.build_nd_pack(sphere["cols"], sphere["pos"], leaf=leaf)
    ours = t_mf.build_nd_pack(sphere["cols"], sphere["pos"], leaf=leaf)
    assert (ours.n, ours.w, ours.stats) == (ref.n, ref.w, ref.stats)
    assert len(ours.levels) == len(ref.levels) > 2
    for a, b in zip(ours.levels, ref.levels):
        assert (a.epad, a.bpad) == (b.epad, b.bpad)
        for field in ("rows", "loc", "child_idx", "child_map", "pad_elim"):
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype, field
            np.testing.assert_array_equal(x, y, err_msg=field)


@pytest.mark.parametrize("leaf", [16, 48])
def test_factor_solve_f64_matches_scipy_and_reference(sphere, leaf):
    pack = t_mf.build_nd_pack(sphere["cols"], sphere["pos"], leaf=leaf)
    levels = pack.device("cpu")
    for table in levels:
        assert all(table[k].dtype == torch.int64
                   for k in ("rows", "asm", "child_idx", "child_map"))
    vals = torch.as_tensor(sphere["vals"])
    factors = t_mf._factor(levels, vals)
    jpack = j_mf.build_nd_pack(sphere["cols"], sphere["pos"], leaf=leaf)
    jlevels = jpack.device()
    jfactors = j_mf._factor_jit(jlevels, sphere["jax"][0])
    rng = np.random.default_rng(1)
    for b in (sphere["rhs"], rng.normal(size=sphere["n"])):
        x = t_mf._solve(levels, factors, torch.as_tensor(b)).numpy()
        assert _rel_res(sphere["a"], x, b) < 1e-11
        ref = np.asarray(j_mf._solve_jit(jlevels, jfactors, jnp.asarray(b)))
        assert np.abs(x - ref).max() <= 1e-10 * np.abs(ref).max()


def test_shift_diag_is_out_of_place(sphere):
    vals = torch.as_tensor(sphere["vals"])
    before = vals.clone()
    slot = torch.as_tensor(sphere["diag_slot"], dtype=torch.int64)
    shifted = t_mf.shift_diag(vals, slot, 1e-6)
    assert torch.equal(vals, before)
    rows = torch.arange(vals.shape[0])
    torch.testing.assert_close(shifted[rows, slot], vals[rows, slot] * (1 + 1e-6),
                               rtol=1e-15, atol=0)
    ref = j_mf.shift_diag(sphere["jax"][0], jnp.asarray(sphere["diag_slot"]), 1e-6)
    np.testing.assert_array_equal(shifted.numpy(), np.asarray(ref))


def test_boundary_mesh_conformal_semidefinite():
    """The open grid with the conformal basis: the system is semidefinite
    (an exact null space); the factor under a 1e-9 relative shift is a
    preconditioner and refinement restores the true residual for a rhs in
    range(A) (tests/test_multifrontal.py:70)."""
    tris, verts = make_grid_mesh(9, jitter=0.02, seed=3)
    s = _system(tris, verts, VectorFieldMode.CONFORMAL)
    pack = t_mf.build_nd_pack(s["cols"], s["pos"], leaf=24)
    vals = torch.as_tensor(s["vals"])
    solver = t_mf.NDSolver(pack, pack.device("cpu"), vals,
                           diag_slot=torch.as_tensor(s["diag_slot"], dtype=torch.int64),
                           shift_rel=1e-9)
    x, stats = refine_loop(torch.as_tensor(s["cols"]), vals, torch.as_tensor(s["rhs"]),
                           lambda r, tol, rn2=None: solver.solve(r), tol=1e-11,
                           inner_floor=1e-12)
    assert _rel_res(s["a"], x.numpy(), s["rhs"]) < 1e-9


def test_ndsolver_f32_with_refinement(sphere):
    """The main path's shape: a float32 factor inside refinement reaches the
    pipeline's outer tolerance in a few direct rounds
    (tests/test_multifrontal.py:120)."""
    pack = t_mf.build_nd_pack(sphere["cols"], sphere["pos"], leaf=32)
    vals32 = torch.as_tensor(sphere["vals"]).to(torch.float32)
    b32 = torch.as_tensor(sphere["rhs"]).to(torch.float32)
    solver = t_mf.NDSolver(pack, pack.device("cpu"), vals32)
    x, stats = refine_loop(torch.as_tensor(sphere["cols"]), vals32, b32,
                           lambda r, tol, rn2=None: solver.solve(r), tol=3e-9,
                           inner_floor=1e-6)
    assert x.dtype == torch.float32
    assert stats.rel_residual < 3e-9
    assert stats.iterations <= 5
    a32 = sphere["a"].astype(np.float32).astype(np.float64)
    assert _rel_res(a32, x.numpy(), b32.numpy().astype(np.float64)) < 5e-7


def _sphere_problem(config, package):
    """tests/test_multifrontal.py's synthetic sphere with the hierarchy (the
    reference's utils/testing.synthetic_sphere_problem) in either package,
    on the same inputs."""
    from meshopticalflow_tpu.utils.testing import _sphere_signals, synthetic_sphere_problem
    from meshopticalflow_tpu_torch.geometry.subdivide import subdivide_tracked
    from meshopticalflow_tpu_torch.utils.testing import octa_sphere

    if package == "jax":
        return synthetic_sphere_problem(config, hierarchy=True)
    tris0, verts0 = octa_sphere(2)
    e0 = verts0[tris0[:, 0]] - verts0[tris0[:, 1]]
    edge_len = 0.6 * float(np.median(np.linalg.norm(e0, axis=1)))
    tris, verts, _, parent, bary = subdivide_tracked(
        tris0, verts0, np.zeros((len(tris0), 3, 2)), edge_len)
    sig = np.stack(_sphere_signals(verts, 0.12))
    return t_pipeline.FlowProblem(config, t_build_mesh(tris, vertices=verts), sig,
                                  vertices=verts, vertex_colors=sig, device="cpu",
                                  root=(tris0, verts0, parent, bary))


@pytest.fixture(scope="module")
def sphere_runs():
    cfg = FlowConfig(dog_weight=0.0, levels=4)
    mg = _sphere_problem(cfg, "torch")
    mf = _sphere_problem(dataclasses.replace(cfg, flow_backend="mf"), "torch")
    ref = _sphere_problem(JaxFlowConfig(dog_weight=0.0, levels=4, flow_backend="mf",
                                        artifact_cache=False), "jax")
    assert ref._ensure_nd() is not None
    return mg, mg.run(), mf, mf.run(), ref.run()


def test_pipeline_mf_backend_matches_mg_and_reference(sphere_runs):
    mg, res_mg, mf, res_mf, res_ref = sphere_runs
    assert mf.nd is not None and mf.init_profile["nd_pack"] >= 0
    assert mg.nd is None
    assert (mf.hier.flow_kind, mf.hier.smooth_kind) == ("xla", "xla")
    assert (mg.hier.flow_kind, mg.hier.smooth_kind) == ("mg3", "mg3")
    assert [m["mf_fallback"] for m in res_mf.metrics] == [0.0] * 4
    assert all(m["flow_iters"] <= 5 for m in res_mf.metrics)
    for other in (res_mg, res_ref):
        tf = np.asarray(other.tfield)
        scale = np.abs(tf).max()
        assert np.abs(res_mf.tfield - tf).max() <= 1e-4 * scale
        err = other.metrics[-1]["alignment_error"]
        assert abs(res_mf.metrics[-1]["alignment_error"] - err) <= 1e-5 * abs(err) + 1e-12


def _level_inputs(prob, negative=0.0):
    """A level's data term on ``prob``'s triangles: SPD blocks, the first
    one replaced by ``-negative`` times the identity when that is nonzero,
    which makes the level system indefinite there (its factor breaks
    down) while its coarse levels stay definite."""
    rng = np.random.default_rng(5)
    t = prob.mesh.n_triangles
    a = rng.normal(size=(t, 2, 2))
    d = np.einsum("tak,tbk->tab", a, a) + 0.1 * np.eye(2)[None]
    if negative:
        d[0] = -negative * np.eye(2)
    kw = dict(dtype=prob.dtype)
    return (torch.as_tensor(d).to(**kw), torch.as_tensor(rng.normal(size=(t, 2))).to(**kw))


NEGATIVE = 5.0   # breaks every factor down; the patch coarsest stays definite


def test_breakdown_falls_back_to_multigrid(sphere_runs):
    """An indefinite level system: the factor is NaN, the shifted refactor
    misses too, and the level goes to the multigrid solver (the three-level
    cycle under mf), which then gives exactly what the multigrid path alone
    gives."""
    _, _, mf, _, _ = sphere_runs
    d_blocks, rhs_t = _level_inputs(mf, NEGATIVE)
    coeffs = torch.zeros(mf.arrays.basis.n_coeffs, dtype=mf.dtype)
    hier, cfg = mf.hier, mf.config
    kw = dict(coarse=hier.coarse, patch=hier.patch, mg_kind=hier.flow_kind,
              refine_tol=cfg.flow_refine_tol, refine_floor=cfg.flow_refine_floor)
    factors = t_mf._factor(mf.nd.levels_dev, t_base.build_flow_system(
        mf.arrays.basis, d_blocks, rhs_t, torch.tensor(1e-7, dtype=mf.dtype))[0])
    assert torch.isnan(factors[-1][0]).all()
    info = {}
    out = t_base.update_optical_flow(mf.arrays.basis, coeffs, d_blocks, rhs_t, 1e-7,
                                     nd=mf.nd, solve_info=info, **kw)
    assert info["mf_fallback"] == 2
    ref = t_base.update_optical_flow(mf.arrays.basis, coeffs, d_blocks, rhs_t, 1e-7, **kw)
    np.testing.assert_array_equal(out[3].numpy(), ref[3].numpy())
    assert out[2].iterations == ref[2].iterations


def test_semidefinite_level_takes_the_shift():
    """The conformal basis on an open grid: the level system has an exact
    null space, so the unshifted float64 factor misses and the 1e-6 shifted
    refactor takes the level (no hierarchy: no multigrid fallback)."""
    tris, verts = make_grid_mesh(9, jitter=0.02, seed=3)
    mesh = t_build_mesh(tris, vertices=verts)
    sig = np.random.default_rng(0).uniform(0, 255, (2, mesh.n_vertices, 3))
    cfg = FlowConfig(vf_mode=1, dtype="float64", flow_backend="mf", use_multigrid=False)
    prob = t_pipeline.FlowProblem(cfg, mesh, sig, vertices=verts, device="cpu")
    d_blocks, rhs_t = _level_inputs(prob)
    coeffs = torch.zeros(prob.arrays.basis.n_coeffs, dtype=prob.dtype)
    info = {}
    _, _, stats, x = t_base.update_optical_flow(
        prob.arrays.basis, coeffs, d_blocks, rhs_t, 1e-3, nd=prob.nd, solve_info=info,
        refine_tol=cfg.flow_refine_tol, refine_floor=cfg.flow_refine_floor)
    assert info["mf_fallback"] == 1
    assert stats.rel_residual <= 100 * cfg.flow_refine_tol
    assert torch.isfinite(x).all()


def test_cli_golden_texture_cube_mf(tmp_path):
    """The port's CLI with --flowBackend mf against the reference binary's
    cube golden, at test_golden_texture_cube_mf's thresholds."""
    from meshopticalflow_tpu_torch.apps.optical_flow import main
    from meshopticalflow_tpu_torch.io.png import read_png_rgb

    devcache.clear()
    out = str(tmp_path / "o.png")
    assert main(["--mesh", os.path.join(GOLD, "cube.ply"), "--in",
                 os.path.join(GOLD, "cA.png"), os.path.join(GOLD, "cB.png"), "--out", out,
                 "--eLength", "0.08", "--dtype", "float64", "--flowBackend", "mf",
                 "--device", "cpu"]) == 0
    devcache.clear()
    ours = read_png_rgb(out).astype(float)
    ref = read_png_rgb(os.path.join(GOLD, "ref_cube.png")).astype(float)
    rmse = float(np.sqrt(((ours - ref) ** 2).mean()))
    exact = float((ours == ref).all(-1).mean())
    assert rmse < 2.5, f"mf texture golden drifted: rmse {rmse:.3f}"
    assert exact > 0.95, f"mf texture golden drifted: exact fraction {exact:.4f}"
