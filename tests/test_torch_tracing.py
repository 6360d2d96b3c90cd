"""Tracing and sampling of the PyTorch port against the reference package.

In float64 on the sphere and the subdivided cube, the same lanes (made with
numpy from a seed) must end in the same triangles with barycentrics within
1e-10, with equal cap-exhausted counts; the round-trip properties of
tests/test_tracing.py hold for the port as well.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meshopticalflow_tpu.geometry.mesh import build_mesh
from meshopticalflow_tpu.geometry.subdivide import subdivide_tracked
from meshopticalflow_tpu.io.ply import read_triangle_mesh
from meshopticalflow_tpu.kernels import advect as j_advect
from meshopticalflow_tpu.kernels import tracing as j_tracing
from meshopticalflow_tpu.utils.testing import octa_sphere
from meshopticalflow_tpu_torch.kernels import advect as t_advect
from meshopticalflow_tpu_torch.kernels import tracing as t_tracing
from tests.conftest import make_grid_mesh

# One intra-op thread: torch's CPU reductions then sum in one order on every
# machine and under any number of test workers.
torch.set_num_threads(1)

F64 = torch.float64
GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
BARY_TOL = 1e-10


def _t(a, dtype=F64):
    return torch.tensor(np.asarray(a)).to(dtype)


def _sphere():
    tris, verts = octa_sphere(3)
    return tris, verts


def _cube():
    data = read_triangle_mesh(os.path.join(GOLD, "cube.ply"))
    diag = float(np.linalg.norm(data.vertices.max(0) - data.vertices.min(0)))
    tris, verts, _, _, _ = subdivide_tracked(data.faces, data.vertices,
                                             data.face_uvs, 0.08 * diag)
    return tris, verts


@pytest.fixture(scope="module", params=["sphere", "cube"])
def surface(request):
    tris, verts = {"sphere": _sphere, "cube": _cube}[request.param]()
    mesh = build_mesh(tris, vertices=verts)
    rng = np.random.default_rng(17)
    t_count = len(tris)
    field = rng.normal(scale=0.4, size=(t_count, 2))
    n = 3 * t_count
    lanes = dict(t0=rng.integers(0, t_count, n),
                 p0=rng.uniform(0.05, 0.45, (n, 2)),
                 times=rng.uniform(-0.8, 0.8, n))
    lanes["t0"][::17] = -1          # inactive lanes pass through
    return dict(name=request.param, tris=tris, mesh=mesh, field=field,
                tm_j=j_tracing.make_trace_mesh(mesh, jnp.float64),
                tm_t=t_tracing.make_trace_mesh(mesh, F64), **lanes)


def _same_endpoints(t_ours, p_ours, t_ref, p_ref):
    t_ours = t_ours.numpy()
    t_ref = np.asarray(t_ref)
    np.testing.assert_array_equal(t_ours, t_ref)
    np.testing.assert_allclose(p_ours.numpy(), np.asarray(p_ref), rtol=0, atol=BARY_TOL)


@pytest.mark.parametrize("max_steps", [7, 4096])
def test_flow_field_trace(surface, max_steps):
    s = surface
    ref = j_tracing.flow_field_trace(
        s["tm_j"], jnp.asarray(s["field"]), jnp.asarray(s["times"]),
        jnp.asarray(s["t0"], jnp.int32), jnp.asarray(s["p0"]), 1e-2,
        max_steps=max_steps, with_diagnostics=True)
    ours = t_tracing.flow_field_trace(
        s["tm_t"], _t(s["field"]), _t(s["times"]), _t(s["t0"], torch.int64),
        _t(s["p0"]), 1e-2, max_steps=max_steps, with_diagnostics=True)
    _same_endpoints(ours[0], ours[1], ref[0], ref[1])
    assert ours[2] == int(ref[2])
    if max_steps == 7:
        assert ours[2] > 0            # the cap binds


@pytest.mark.parametrize("max_steps,escalate", [(16, 2), (4096, 16)])
def test_flow_field_trace_compacted(surface, max_steps, escalate):
    s = surface
    ref = j_advect.flow_field_trace_compacted(
        s["tm_j"], jnp.asarray(s["field"]), jnp.asarray(s["times"]),
        jnp.asarray(s["t0"], jnp.int32), jnp.asarray(s["p0"]), 1e-2,
        max_steps=max_steps, escalate=escalate)
    ours = t_advect.flow_field_trace_compacted(
        s["tm_t"], _t(s["field"]), _t(s["times"]), _t(s["t0"], torch.int64),
        _t(s["p0"]), 1e-2, max_steps=max_steps, escalate=escalate, check_every=8)
    _same_endpoints(ours[0], ours[1], ref[0], ref[1])
    assert ours[2] == int(ref[2])


def test_exp_map(surface):
    s = surface
    rng = np.random.default_rng(5)
    n = s["t0"].shape[0]
    v = rng.normal(scale=0.6, size=(n, 2))
    # starting points on chart edges exercise the pre-step
    p = s["p0"].copy()
    p[::5, 0] = 0.0
    p[1::5, 1] = 0.0
    for max_steps in (3, 1024):
        ref = j_tracing.exp_map(s["tm_j"], jnp.asarray(s["t0"], jnp.int32),
                                jnp.asarray(p), jnp.asarray(v), max_steps=max_steps,
                                with_diagnostics=True)
        ours = t_tracing.exp_map(s["tm_t"], _t(s["t0"], torch.int64), _t(p), _t(v),
                                 max_steps=max_steps, with_diagnostics=True)
        _same_endpoints(ours[0], ours[1], ref[0], ref[1])
        assert ours[2] == int(ref[2])


def test_resample_signal(surface):
    s = surface
    values = np.random.default_rng(8).uniform(0, 255, (s["mesh"].n_vertices, 3))
    ref = j_advect.resample_signal(s["tm_j"], jnp.asarray(s["field"]),
                                   jnp.asarray(values), 0.3)
    ours = t_advect.resample_signal(s["tm_t"], _t(s["field"]), _t(values), 0.3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("bilinear,quad", [(True, False), (True, True), (False, False)])
def test_sample_texture_bilinear(bilinear, quad):
    rng = np.random.default_rng(2)
    tex = rng.integers(0, 256, (9, 13, 3)).astype(np.float64)
    uv = np.concatenate([rng.uniform(-0.1, 1.1, (300, 2)),
                         np.array([[0.0, 0.0], [1.0, 1.0], [0.0, 1.0], [1.0, 0.0]])])
    q_j = j_advect.build_quad_table(jnp.asarray(tex)) if quad else None
    q_t = t_advect.build_quad_table(_t(tex)) if quad else None
    if quad:
        np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    ref = j_advect.sample_texture_bilinear(jnp.asarray(tex), jnp.asarray(uv),
                                           bilinear, quad=q_j)
    ours = t_advect.sample_texture_bilinear(_t(tex), _t(uv), bilinear, quad=q_t)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-9)


# -- round-trip properties (tests/test_tracing.py) ---------------------------

def _chart_frames(tris, verts):
    p = verts[tris]
    return np.stack([p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]], axis=-1)


def _embed(tris, verts, t, p):
    v = verts[tris[t]]
    return v[:, 0] * (1 - p[:, 0] - p[:, 1])[:, None] + v[:, 1] * p[:, 0:1] + v[:, 2] * p[:, 1:2]


@pytest.fixture(scope="module")
def flat():
    tris, verts = make_grid_mesh(8)
    mesh = build_mesh(tris, vertices=verts, make_unit_area=False)
    return tris, verts, mesh, t_tracing.make_trace_mesh(mesh, F64)


def test_zero_field_is_identity(flat):
    tris, verts, mesh, tm = flat
    t0 = torch.arange(mesh.n_triangles)
    p0 = torch.full((mesh.n_triangles, 2), 1 / 3, dtype=F64)
    t1, p1 = t_tracing.flow_field_trace(tm, torch.zeros((mesh.n_triangles, 2), dtype=F64),
                                        0.5, t0, p0, min_step=1e-2)
    assert torch.equal(t1, t0)
    torch.testing.assert_close(p1, p0)


def test_constant_field_flat_mesh_translates(flat):
    tris, verts, mesh, tm = flat
    w = np.array([0.31, 0.17])
    frames = _chart_frames(tris, verts)[:, :2, :]
    vf = np.linalg.solve(frames, np.broadcast_to(w, (len(tris), 2))[..., None])[..., 0]
    centers = _embed(tris, verts, np.arange(len(tris)), np.full((len(tris), 2), 1 / 3))
    inner = np.nonzero((centers[:, 0] > 0.35) & (centers[:, 0] < 0.6)
                       & (centers[:, 1] > 0.35) & (centers[:, 1] < 0.6))[0]
    p0 = torch.full((len(inner), 2), 1 / 3, dtype=F64)
    for ft in (0.9, -0.9):
        t1, p1 = t_tracing.flow_field_trace(tm, _t(vf), ft, _t(inner, torch.int64), p0,
                                            min_step=1e-2)
        end = _embed(tris, verts, t1.numpy(), p1.numpy())
        np.testing.assert_allclose(end[:, :2], centers[inner][:, :2] + w * ft, atol=1e-9)


def test_flow_round_trip_sphere():
    tris, verts = octa_sphere(3)
    mesh = build_mesh(tris, vertices=verts)
    tm = t_tracing.make_trace_mesh(mesh, F64)
    frames3 = _chart_frames(tris, verts)
    centers = verts[tris].mean(1)
    embedded = np.cross(np.broadcast_to([0.0, 0.0, 1.0], centers.shape), centers)
    vf = np.linalg.solve(np.einsum("tia,tib->tab", frames3, frames3),
                         np.einsum("tia,ti->ta", frames3, embedded)[..., None])[..., 0]
    vf = _t(vf * 0.05 / np.abs(vf).max())
    t0 = torch.arange(mesh.n_triangles)
    p0 = torch.full((mesh.n_triangles, 2), 1 / 3, dtype=F64)
    t1, p1 = t_tracing.flow_field_trace(tm, vf, 0.4, t0, p0, min_step=1e-3)
    t2, p2 = t_tracing.flow_field_trace(tm, vf, -0.4, t1, p1, min_step=1e-3)
    start = _embed(tris, verts, t0.numpy(), p0.numpy())
    end = _embed(tris, verts, t2.numpy(), p2.numpy())
    err = np.linalg.norm(start - end, axis=1)
    assert np.median(err) < 2e-3
    assert err.max() < 5e-2


def test_exp_map_flat_straight_line(flat):
    tris, verts, mesh, tm = flat
    centers = _embed(tris, verts, np.arange(len(tris)), np.full((len(tris), 2), 1 / 3))
    inner = np.nonzero((np.abs(centers[:, 0] - 0.4) < 0.15)
                       & (np.abs(centers[:, 1] - 0.4) < 0.15))[0]
    frames = _chart_frames(tris, verts)[inner, :2, :]
    w = np.array([0.21, -0.13])
    v = np.linalg.solve(frames, np.broadcast_to(w, (len(inner), 2))[..., None])[..., 0]
    t1, p1 = t_tracing.exp_map(tm, _t(inner, torch.int64),
                               torch.full((len(inner), 2), 1 / 3, dtype=F64), _t(v))
    end = _embed(tris, verts, t1.numpy(), p1.numpy())
    np.testing.assert_allclose(end[:, :2], centers[inner][:, :2] + w, atol=1e-9)


def test_compacted_trace_equals_plain(flat):
    tris, verts, mesh, tm = flat
    t_count = mesh.n_triangles
    rng = np.random.default_rng(11)
    vf = _t(rng.normal(scale=0.25, size=(t_count, 2)))
    n = 3 * t_count
    t0 = _t(rng.integers(0, t_count, n), torch.int64)
    p0 = _t(rng.uniform(0.05, 0.4, (n, 2)))
    times = _t(rng.uniform(-0.6, 0.6, n))
    t_ref, p_ref = t_tracing.flow_field_trace(tm, vf, times, t0, p0, min_step=1e-2,
                                              max_steps=512)
    t_c, p_c, exhausted = t_advect.flow_field_trace_compacted(
        tm, vf, times, t0, p0, min_step=1e-2, max_steps=512, check_every=4)
    assert exhausted == 0
    assert torch.equal(t_c, t_ref)
    assert torch.equal(p_c, p_ref)


def test_compacted_trace_escalates_past_cap(flat):
    tris, verts, mesh, tm = flat
    t_count = mesh.n_triangles
    rng = np.random.default_rng(12)
    vf = _t(rng.normal(scale=1.0, size=(t_count, 2)))
    n = 2 * t_count
    t0 = _t(rng.integers(0, t_count, n), torch.int64)
    p0 = _t(rng.uniform(0.05, 0.4, (n, 2)))
    times = _t(rng.uniform(-2.0, 2.0, n))
    t_ref, p_ref = t_tracing.flow_field_trace(tm, vf, times, t0, p0, min_step=1e-2,
                                              max_steps=8192)
    _, _, frozen = t_tracing.flow_field_trace(tm, vf, times, t0, p0, min_step=1e-2,
                                              max_steps=16, with_diagnostics=True)
    assert frozen > 0
    t_c, p_c, exhausted = t_advect.flow_field_trace_compacted(
        tm, vf, times, t0, p0, min_step=1e-2, max_steps=16, escalate=1024)
    assert exhausted == 0
    assert torch.equal(t_c, t_ref)
    assert torch.equal(p_c, p_ref)
