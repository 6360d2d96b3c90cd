"""Tracking and baking of the PyTorch port against the reference package.

* The Whitney, gradient and distance traces and the multi-pair trace, in
  float64 on the sphere and the subdivided cube: the same lanes end in the
  same triangles with barycentrics within 1e-12 of the reference's; each
  pair of the multi-pair trace equals its solo trace exactly.
* The composed Whitney resampling within 1e-12; the N-frame texture
  advection and the problem-level texture outputs from the reference's
  state within 1e-9.
* The TrackSequence CLI of both packages in float64: vertex mode over
  a b a with --composed (halfway PLYs equal but for knife-edge channels,
  the flow dumps, alignment errors and composed colours within 1e-9), and
  texture mode over the 256^2 cube's mA mB mA against ref_cube256.png.
* The SampleTextureToVertices CLI of both packages: byte-equal PLYs.
"""

import json
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
from meshopticalflow_tpu_torch.models.whitney import edge_reduction

torch.set_num_threads(1)

F64 = torch.float64
GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
BARY_TOL = 1e-12


def _t(a, dtype=F64):
    return torch.tensor(np.asarray(a)).to(dtype)


def _cube_geometry(fraction=0.08):
    data = read_triangle_mesh(os.path.join(GOLD, "cube.ply"))
    diag = float(np.linalg.norm(data.vertices.max(0) - data.vertices.min(0)))
    tris, verts, uvs, _, _ = subdivide_tracked(data.faces, data.vertices, data.face_uvs,
                                               fraction * diag)
    return tris, verts, uvs


@pytest.fixture(scope="module", params=["sphere", "cube"])
def surface(request):
    if request.param == "sphere":
        tris, verts = octa_sphere(3)
        uvs = None
    else:
        tris, verts, uvs = _cube_geometry()
    mesh = build_mesh(tris, vertices=verts)
    rng = np.random.default_rng(23)
    t_count = len(tris)
    red, sign, expanded = edge_reduction(mesh.opp)
    n = 2 * t_count
    lanes = dict(t0=rng.integers(0, t_count, n), p0=rng.uniform(0.05, 0.45, (n, 2)),
                 times=rng.uniform(-0.8, 0.8, n))
    lanes["t0"][::17] = -1          # inactive lanes pass through
    return dict(name=request.param, tris=tris, verts=verts, uvs=uvs, mesh=mesh,
                ce=[rng.normal(scale=0.3, size=len(expanded))[red] * sign for _ in range(2)],
                fields=rng.normal(scale=0.4, size=(2, t_count, 2)),
                potential=rng.normal(size=len(verts)),
                tm_j=j_tracing.make_trace_mesh(mesh, jnp.float64),
                tm_t=t_tracing.make_trace_mesh(mesh, F64), **lanes)


def _lanes(s):
    return ((jnp.asarray(s["t0"], jnp.int32), jnp.asarray(s["p0"])),
            (_t(s["t0"], torch.int64), _t(s["p0"])))


def _same_endpoints(t_ours, p_ours, t_ref, p_ref):
    np.testing.assert_array_equal(t_ours.numpy(), np.asarray(t_ref))
    np.testing.assert_allclose(p_ours.numpy(), np.asarray(p_ref), rtol=0, atol=BARY_TOL)


@pytest.mark.parametrize("max_steps", [7, 4096])
def test_whitney_flow_trace(surface, max_steps):
    s = surface
    (tj, pj), (tt, pt) = _lanes(s)
    ref = j_tracing.whitney_flow_trace(s["tm_j"], jnp.asarray(s["ce"][0]),
                                       jnp.asarray(s["times"]), tj, pj, 1e-2,
                                       max_steps=max_steps, with_diagnostics=True)
    ours = t_tracing.whitney_flow_trace(s["tm_t"], _t(s["ce"][0]), _t(s["times"]), tt, pt,
                                        1e-2, max_steps=max_steps, with_diagnostics=True)
    _same_endpoints(ours[0], ours[1], ref[0], ref[1])
    assert ours[2] == int(ref[2])
    if max_steps == 7:
        assert ours[2] > 0            # the cap binds


@pytest.mark.parametrize("target", ["none", "per_lane"])
def test_gradient_flow_trace(surface, target):
    s = surface
    (tj, pj), (tt, pt) = _lanes(s)
    tgt = -1 if target == "none" else \
        np.random.default_rng(5).integers(0, len(s["verts"]), len(s["t0"]))
    ref = j_tracing.gradient_flow_trace(s["tm_j"], jnp.asarray(s["potential"]), tj, pj, 1e-2,
                                        target_vertex=jnp.asarray(tgt, jnp.int32))
    ours = t_tracing.gradient_flow_trace(s["tm_t"], _t(s["potential"]), tt, pt, 1e-2,
                                         target_vertex=torch.as_tensor(tgt))
    _same_endpoints(ours[0], ours[1], ref[0], ref[1])
    np.testing.assert_allclose(ours[2].numpy(), np.asarray(ref[2]), rtol=0, atol=BARY_TOL)
    assert float(ours[2].max()) > 0


def test_flow_field_trace_distance(surface):
    s = surface
    (tj, pj), (tt, pt) = _lanes(s)
    ref = j_tracing.flow_field_trace_distance(s["tm_j"], jnp.asarray(s["fields"][0]),
                                              jnp.asarray(s["times"]), tj, pj)
    ours = t_tracing.flow_field_trace_distance(s["tm_t"], _t(s["fields"][0]),
                                               _t(s["times"]), tt, pt)
    _same_endpoints(ours[0], ours[1], ref[0], ref[1])
    np.testing.assert_allclose(ours[2].numpy(), np.asarray(ref[2]), rtol=0, atol=BARY_TOL)


@pytest.mark.parametrize("flow_times", [0.4, (0.4, -0.3)])
def test_flow_field_trace_pairs(surface, flow_times):
    s = surface
    (tj, pj), (tt, pt) = _lanes(s)
    ref = j_advect.flow_field_trace_pairs(s["tm_j"], jnp.asarray(s["fields"]),
                                          jnp.asarray(flow_times), tj, pj, 1e-2)
    ours = t_advect.flow_field_trace_pairs(s["tm_t"], _t(s["fields"]), flow_times, tt, pt,
                                           1e-2)
    times = np.broadcast_to(flow_times, (2,))
    for k in range(2):
        _same_endpoints(ours[0][k], ours[1][k], ref[0][k], ref[1][k])
        solo = t_tracing.flow_field_trace(s["tm_t"], _t(s["fields"][k]), float(times[k]),
                                          tt, pt, 1e-2)
        assert torch.equal(ours[0][k], solo[0]) and torch.equal(ours[1][k], solo[1])


def test_resample_signal_composed_whitney(surface):
    s = surface
    values = np.random.default_rng(9).uniform(0, 255, (len(s["verts"]), 3))
    ref = j_advect.resample_signal_composed_whitney(
        s["tm_j"], jnp.asarray(np.stack(s["ce"])), jnp.asarray(values), 0.5)
    ours = t_advect.resample_signal_composed_whitney(s["tm_t"], _t(np.stack(s["ce"])),
                                                     _t(values), 0.5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-12 * 255)
    assert not np.allclose(ours.numpy(), values)


@pytest.mark.parametrize("bilinear", [True, False])
def test_advect_texture_frames_scan(bilinear):
    from meshopticalflow_tpu_torch.geometry.rasterize import rasterize_texture_source
    from meshopticalflow_tpu_torch.io.png import read_png_rgb

    tris, verts, uvs = _cube_geometry()
    mesh = build_mesh(tris, vertices=verts)
    tex = read_png_rgb(os.path.join(GOLD, "mA.png"))[::4, ::4].astype(np.float64)
    h, w = tex.shape[:2]
    src = rasterize_texture_source(uvs, w, h, 2)
    field = np.random.default_rng(4).normal(scale=0.3, size=(len(tris), 2))
    quad = t_advect.build_quad_table(_t(tex)) if bilinear else None
    quad_j = j_advect.build_quad_table(jnp.asarray(tex)) if bilinear else None
    ref = j_advect.advect_texture_frames_scan(
        j_tracing.make_trace_mesh(mesh, jnp.float64), jnp.asarray(field), jnp.asarray(uvs),
        jnp.asarray(tex), jnp.asarray(src.tri_idx, jnp.int32), jnp.asarray(src.bary),
        jnp.asarray(-0.5), 3, bilinear=bilinear, quad=quad_j)
    ours = t_advect.advect_texture_frames_scan(
        t_tracing.make_trace_mesh(mesh, F64), _t(field), _t(uvs), _t(tex),
        _t(src.tri_idx, torch.int64), _t(src.bary), -0.5, 3, bilinear=bilinear, quad=quad)
    assert ours.shape == (2, h * w, 3)
    off = np.abs(ours.numpy() - np.asarray(ref)).max(-1) > 1e-9
    if bilinear:
        assert not off.any()
    else:
        # Nearest sampling floors the texel coordinate: lanes that end on a
        # chart edge land on integer coordinates to the last ulp, where the
        # two packages' roundings of the uv blend pick neighbouring texels.
        t, p = _t(src.tri_idx, torch.int64), _t(src.bary)
        tm = t_tracing.make_trace_mesh(mesh, F64)
        for frame in range(2):
            t, p = t_tracing.flow_field_trace(tm, _t(field), -0.5, t, p, 3e-2)
            c = uvs[np.maximum(t.numpy(), 0)]
            q = p.numpy()
            uv = c[:, 0] * (1 - q[:, 0] - q[:, 1])[:, None] + c[:, 1] * q[:, :1] \
                + c[:, 2] * q[:, 1:]
            xy = np.stack([uv[:, 0] * (w - 1), (1 - uv[:, 1]) * (h - 1)], -1)
            knife = (np.abs(xy - np.round(xy)) < 1e-9).any(-1)
            assert not (off[frame] & ~knife).any() and off[frame].mean() < 0.01


def test_texture_outputs_from_reference_state():
    """advected_textures and advected_texture_frames of a port problem
    holding the reference's final state (meshopticalflow_tpu_torch.convert)."""
    from meshopticalflow_tpu.config import FlowConfig as JaxFlowConfig
    from meshopticalflow_tpu.flow import pipeline as j_pipeline
    from meshopticalflow_tpu_torch import convert
    from meshopticalflow_tpu_torch.config import FlowConfig
    from meshopticalflow_tpu_torch.flow import pipeline as t_pipeline

    kw = dict(dtype="float64", use_multigrid=False, levels=2, subdivide_edge_length=0.08)
    paths = (os.path.join(GOLD, "cA.png"), os.path.join(GOLD, "cB.png"))
    mesh = os.path.join(GOLD, "cube.ply")
    jp = j_pipeline.FlowProblem.from_texture_inputs(
        mesh, paths, JaxFlowConfig(artifact_cache=False, **kw))
    jp.run()
    tp = t_pipeline.FlowProblem.from_texture_inputs(
        mesh, paths, FlowConfig(artifact_cache=False, **kw), device="cpu")
    convert.load_state(tp, jp)
    assert np.abs(np.asarray(jp.tfield)).max() > 0
    np.testing.assert_allclose(tp.advected_textures(), np.asarray(jp.advected_textures()),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(tp.advected_texture_frames(3),
                               np.asarray(jp.advected_texture_frames(3)), rtol=0, atol=1e-9)


# -- the CLIs ----------------------------------------------------------------

def _track(tmp_path, monkeypatch, package, argv):
    import importlib

    monkeypatch.setenv("MESHFLOW_CACHE", str(tmp_path / "artifacts"))
    main = importlib.import_module(f"{package}.apps.track_sequence").main
    out = tmp_path / package
    extra = ["--device", "cpu"] if package.endswith("torch") else []
    assert main(argv + ["--outDir", str(out), "--dtype", "float64"] + extra) == 0
    return out


def test_track_sequence_vertex_cli_matches_reference(tmp_path, monkeypatch):
    from meshopticalflow_tpu.io.binio import read_vector

    a, b = os.path.join(GOLD, "a.ply"), os.path.join(GOLD, "b.ply")
    argv = ["--in", a, b, a, "--composed"]
    ref = _track(tmp_path, monkeypatch, "meshopticalflow_tpu", argv)
    ours = _track(tmp_path, monkeypatch, "meshopticalflow_tpu_torch", argv)
    m_ref = [json.loads(x) for x in open(ref / "metrics.jsonl")]
    *m_ours, m_composed = [json.loads(x) for x in open(ours / "metrics.jsonl")]
    assert [m["pair"] for m in m_ours] == [m["pair"] for m in m_ref] == [0, 1]
    assert m_composed["composed_frames"] == 3 and m_composed["composed_seconds"] > 0
    for mo, mr in zip(m_ours, m_ref):
        assert abs(mo["alignment_error"] - mr["alignment_error"]) \
            <= 1e-9 * abs(mr["alignment_error"])
        assert len(mo["flow_iters"]) == 10
    for i in (0, 1):
        vo = read_vector(str(ours / f"vectorField_{i:03d}.bin"), width=2)
        vr = read_vector(str(ref / f"vectorField_{i:03d}.bin"), width=2)
        assert vo.shape == vr.shape
        np.testing.assert_allclose(vo, vr, rtol=0, atol=1e-9 * np.abs(vr).max())
    # u8 outputs: a channel whose float64 value lies within 1e-9 of an
    # integer (a knife edge) may land one level apart
    for name in ("halfway_000.ply", "halfway_001.ply", "composed_resampled.ply"):
        co = read_triangle_mesh(str(ours / name)).colors.astype(int)
        cr = read_triangle_mesh(str(ref / name)).colors.astype(int)
        assert co.shape == cr.shape
        assert np.abs(co - cr).max() <= 1 and (co != cr).sum() <= 2, name
    comp = read_triangle_mesh(str(ours / "composed_resampled.ply")).colors
    assert not np.array_equal(comp, read_triangle_mesh(a).colors)


def test_track_sequence_texture_cli_golden(tmp_path, monkeypatch):
    from meshopticalflow_tpu_torch.io.png import read_png_rgb

    ma, mb = os.path.join(GOLD, "mA.png"), os.path.join(GOLD, "mB.png")
    out = _track(tmp_path, monkeypatch, "meshopticalflow_tpu_torch",
                 ["--mesh", os.path.join(GOLD, "cube.ply"), "--in", ma, mb, ma,
                  "--eLength", "0.06"])
    ref = read_png_rgb(os.path.join(GOLD, "ref_cube256.png")).astype(float)
    for i in (0, 1):
        ours = read_png_rgb(str(out / f"halfway_{i:03d}.png")).astype(float)
        rmse = float(np.sqrt(((ours - ref) ** 2).mean()))
        exact = float((ours == ref).all(-1).mean())
        within1 = float((np.abs(ours - ref) <= 1).all(-1).mean())
        assert rmse < 2.2 and exact > 0.97 and within1 > 0.995, (i, rmse, exact, within1)
    assert len(open(out / "metrics.jsonl").readlines()) == 2


def test_sample_texture_to_vertices_cli_matches_reference(tmp_path):
    from meshopticalflow_tpu.apps.sample_texture_to_vertices import main as j_main
    from meshopticalflow_tpu_torch.apps.sample_texture_to_vertices import main as t_main

    argv = ["--in", os.path.join(GOLD, "cube.ply"), "--texture", os.path.join(GOLD, "mA.png"),
            "--eLength", "0.06"]
    assert j_main(argv + ["--out", str(tmp_path / "ref.ply")]) == 0
    assert t_main(argv + ["--out", str(tmp_path / "ours.ply")]) == 0
    with open(tmp_path / "ref.ply", "rb") as f, open(tmp_path / "ours.ply", "rb") as g:
        assert f.read() == g.read()
    assert t_main(["--in", os.path.join(GOLD, "a.ply"), "--texture",
                   os.path.join(GOLD, "mA.png"), "--out", str(tmp_path / "x.ply")]) == 1


def test_track_sequence_refuses_cuda_without_gpu(tmp_path, monkeypatch):
    from meshopticalflow_tpu_torch.apps.track_sequence import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, b = os.path.join(GOLD, "a.ply"), os.path.join(GOLD, "b.ply")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--in", a, b, "--outDir", str(tmp_path)])
