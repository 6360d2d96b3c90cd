"""The port's viewer (meshopticalflow_tpu_torch/viz) against the JAX package's.

The cases of tests/test_viz.py and tests/test_live_view.py run headless
against the port's jax-free copies, with the port's FlowProblem behind
``view_flow``; ``render_rgb`` equals the reference's frame bit for bit; a
level stepped by the viewer computes the tfield ``FlowProblem.run`` computes,
bit for bit; the OpticalFlow CLI without --out and Spectrum --view write
their frames.
"""

import io
import os

import numpy as np
import pytest
import torch

from meshopticalflow_tpu.viz import live as j_live
from meshopticalflow_tpu.viz import surface as j_surface
from meshopticalflow_tpu.utils.testing import sphere_signal_pair
from meshopticalflow_tpu_torch.config import FlowConfig
from meshopticalflow_tpu_torch.flow.pipeline import FlowProblem
from meshopticalflow_tpu_torch.geometry.mesh import build_mesh
from meshopticalflow_tpu_torch.io.png import read_png_rgb
from meshopticalflow_tpu_torch.viz import Camera, render_surface, view_flow, view_spectrum
from meshopticalflow_tpu_torch.viz.live import (KeyboardCallBack, LiveViewer,
                                                TerminalDisplay, _token_keys,
                                                frame_to_ansi, render_rgb)

from conftest import make_grid_mesh, make_sphere_mesh

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "golden")


@pytest.fixture(autouse=True)
def _headless(tmp_path, monkeypatch):
    """No display, no live viewer unless a case asks for it, and the
    artifact cache under the test's own directory."""
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.setenv("MESHFLOW_LIVE", "0")
    monkeypatch.setenv("MESHFLOW_CACHE", str(tmp_path / "artifacts"))


def _sphere_problem(levels=2):
    """tests/test_viz.py:49-51's problem in the port."""
    tris, verts, s0, s1 = sphere_signal_pair(2)
    sig = np.stack([s0, s1])
    cfg = FlowConfig(dog_weight=0.0, levels=levels, dtype="float64", cg_max_iters=100,
                     artifact_cache=False)
    return FlowProblem(cfg, build_mesh(tris, vertices=verts), sig, vertices=verts,
                       vertex_colors=sig, device="cpu")


# ---- tests/test_viz.py ---------------------------------------------------

def test_render_surface_colored_and_glyphs(tmp_path):
    tris, verts = make_sphere_mesh(2)
    rng = np.random.default_rng(0)
    colors = rng.uniform(0, 255, (len(verts), 3))
    vfield = rng.normal(size=(len(tris), 2)) * 0.1
    out = str(tmp_path / "render.png")
    render_surface(verts, tris, out, vertex_colors=colors, vfield=vfield)
    img = read_png_rgb(out)
    assert img.shape[0] > 100 and img.shape[2] >= 3
    assert img[..., :3].std() > 1.0


def test_render_surface_textured(tmp_path):
    tris, verts = make_grid_mesh(5)
    rng = np.random.default_rng(1)
    tex = rng.integers(0, 255, (16, 16, 3)).astype(np.uint8)
    out = str(tmp_path / "textured.png")
    render_surface(verts, tris, out, texture=tex, tri_uvs=verts[tris][:, :, :2])
    assert os.path.exists(out)


def test_camera_save_load_roundtrip(tmp_path):
    cam = Camera(azimuth=1.0, elevation=-0.2, distance=2.5, target=(1, 2, 3))
    p = str(tmp_path / "camera.json")
    cam.save(p)
    assert Camera.load(p) == cam
    assert j_surface.Camera.load(p) == j_surface.Camera(1.0, -0.2, 2.5, (1, 2, 3))


def test_view_flow_headless_writes_frames(tmp_path):
    prob = _sphere_problem()
    n = view_flow(prob, out_dir=str(tmp_path), interactive=False)
    assert n == 2
    for lvl in range(3):
        assert (tmp_path / f"level_{lvl:03d}.png").exists()
    assert (tmp_path / "camera.json").exists()


def test_view_spectrum_headless_writes_frames(tmp_path):
    tris, verts = make_sphere_mesh(2)
    fields = np.random.default_rng(2).normal(size=(3, len(tris), 2)) * 0.1
    n = view_spectrum(verts, tris, fields, np.array([0.1, 0.5, 1.2]), out_dir=str(tmp_path),
                      interactive=False)
    assert n == 3
    for i in range(3):
        assert (tmp_path / f"eigenfield_{i + 1:03d}.png").exists()
    assert (tmp_path / "camera.json").exists()


# ---- tests/test_live_view.py ---------------------------------------------

def _two_triangles():
    verts = np.array([
        [-1.0, -1.0, 0.0], [1.0, -1.0, 0.0], [0.0, 1.0, 0.0],   # far
        [-1.0, -1.0, 1.0], [1.0, -1.0, 1.0], [0.0, 1.0, 1.0],   # near
    ])
    return verts, np.array([[0, 1, 2], [3, 4, 5]])


def test_render_rgb_zbuffer_front_wins():
    verts, tris = _two_triangles()
    cam = Camera(azimuth=0.0, elevation=1.45, distance=3.0, target=(0.0, 0.0, 0.5))
    colors = np.array([[255, 0, 0], [0, 255, 0]], float)
    img = render_rgb(verts, tris, cam, 64, 64, face_colors=colors)
    center = img[28:36, 28:36].reshape(-1, 3).astype(int)
    on_mesh = center[(center.sum(axis=1) > 60)]
    assert len(on_mesh) > 0
    assert (on_mesh[:, 1] > on_mesh[:, 0]).all()


def test_render_rgb_covers_and_offscreen_safe():
    verts, tris = _two_triangles()
    img = render_rgb(verts, tris, Camera(target=(0, 0, 0.5)), 48, 40)
    assert img.shape == (40, 48, 3)
    img2 = render_rgb(verts, tris, Camera(target=(1e6, 1e6, 1e6)), 16, 16)
    assert (img2 == img2[0, 0]).all()


@pytest.mark.parametrize("case", ["faces", "vertex_colors_glyphs", "zoomed"])
def test_render_rgb_equals_reference(case):
    """The port's rasterizer frame equals the reference's, bit for bit."""
    tris, verts = make_sphere_mesh(3)
    rng = np.random.default_rng(4)
    kw = {"faces": dict(face_colors=rng.uniform(0, 255, (len(tris), 3))),
          "vertex_colors_glyphs": dict(vertex_colors=rng.uniform(0, 255, (len(verts), 3)),
                                       vfield=rng.normal(size=(len(tris), 2)) * 0.1),
          "zoomed": dict(zoom=1.7)}[case]
    cam = dict(azimuth=0.7, elevation=0.3, distance=2.0, target=(0.1, 0.0, -0.05))
    a = render_rgb(verts, tris, Camera(**cam), 96, 72, **kw)
    b = j_live.render_rgb(verts, tris, j_surface.Camera(**cam), 96, 72, **kw)
    assert a.dtype == b.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    assert frame_to_ansi(a, "s") == j_live.frame_to_ansi(b, "s")


def test_frame_to_ansi_halfblocks():
    img = np.zeros((4, 3, 3), np.uint8)
    img[0, :, 0] = 255
    txt = frame_to_ansi(img, status="hello")
    assert "▀" in txt and "\x1b[38;2;255;0;0m" in txt and "hello" in txt
    assert "▀" in frame_to_ansi(np.zeros((3, 2, 3), np.uint8))


def test_token_keys_decode():
    assert list(_token_keys(io.StringIO("l + left\nq\n"))) == ["l", "+", "left", "q"]


def _viewer(tmp_path, keys, **kw):
    verts, tris = _two_triangles()
    out = io.StringIO()
    v = LiveViewer(verts, tris, out_dir=str(tmp_path), display=TerminalDisplay(stream=out),
                   key_source=iter(keys), **kw)
    return v, out


def test_live_loop_orbit_zoom_pan_quit(tmp_path):
    v, out = _viewer(tmp_path, ["l", "k", "+", "L", "q"])
    az0, el0, d0, t0 = (v.camera.azimuth, v.camera.elevation, v.camera.distance,
                        v.camera.target)
    assert v.run() >= 5
    assert v.camera.azimuth > az0 and v.camera.elevation > el0
    assert v.camera.distance < d0 and v.camera.target != t0
    text = out.getvalue()
    assert "▀" in text and "az " in text and "\x1b[?25h" in text


def test_live_export_and_camera_save(tmp_path):
    v, _ = _viewer(tmp_path, ["o", "c", "q"])
    v.run()
    assert os.path.exists(tmp_path / "live_export_000.png")
    assert Camera.load(str(tmp_path / "camera.json")).distance == v.camera.distance


def test_live_help_and_custom_callback(tmp_path):
    hits = []
    v, out = _viewer(tmp_path, ["?", "x", "q"])
    v.add_key("x", "custom action", lambda: hits.append(1))
    v.run()
    assert hits == [1]
    assert "orbit left" in out.getvalue() and "custom action" in out.getvalue()
    assert all(isinstance(cb, KeyboardCallBack) for cb in v.callbacks)


def test_live_color_and_vfield_sources(tmp_path):
    verts, tris = _two_triangles()
    out = io.StringIO()
    polled = {"c": 0}

    def colors():
        polled["c"] += 1
        return np.tile([[0, 0, 255]], (len(verts), 1)).astype(float)

    v = LiveViewer(verts, tris, out_dir=str(tmp_path), display=TerminalDisplay(stream=out),
                   key_source=iter(["l", "q"]), color_source=colors,
                   vfield_source=lambda: np.full((len(tris), 2), 0.1))
    v.run()
    assert polled["c"] >= 2
    assert "\x1b[38;2;" in out.getvalue()


def test_unbound_key_is_ignored(tmp_path):
    v, _ = _viewer(tmp_path, ["Z", "q"])
    assert v.run() >= 2


def test_view_spectrum_routes_to_live(tmp_path, monkeypatch):
    tris, verts = make_sphere_mesh(2)
    fields = np.random.default_rng(2).normal(size=(3, len(tris), 2)) * 0.1
    monkeypatch.setenv("MESHFLOW_LIVE", "1")
    monkeypatch.setattr("sys.stdin", io.StringIO("n n b o q\n"))
    assert view_spectrum(verts, tris, fields, np.array([0.1, 0.2, 0.3]),
                         out_dir=str(tmp_path)) == 3
    assert os.path.exists(tmp_path / "live_export_000.png")


def test_view_spectrum_live_off_stays_headless(tmp_path):
    tris, verts = make_sphere_mesh(2)
    view_spectrum(verts, tris, np.zeros((2, len(tris), 2)), out_dir=str(tmp_path))
    assert os.path.exists(tmp_path / "eigenfield_001.png")


def test_prompt_token_stream(tmp_path):
    got = []
    v, out = _viewer(tmp_path, ["p", "3.5", "q"])
    v.add_key("p", "prompt demo", lambda: got.append(v.prompt("value: ")))
    v.run()
    assert got == ["3.5"] and "value: " in out.getvalue()


def test_view_flow_live_weight_prompt_and_advance(tmp_path, monkeypatch):
    """'w' typed-weight edit, 'a' advance, 'q' quit through the real
    view_flow entry, on the port's FlowProblem."""
    prob = _sphere_problem()
    monkeypatch.setenv("MESHFLOW_LIVE", "1")
    monkeypatch.setattr("sys.stdin", io.StringIO("w 0.125 a t v o q\n"))
    assert view_flow(prob, out_dir=str(tmp_path), interactive=False) == 1
    assert os.path.exists(tmp_path / "live_export_000.png")


def test_render_rgb_zoom_scales_coverage():
    verts, tris = _two_triangles()
    cam = Camera(target=(0, 0, 0.5))
    bg = np.array([12, 12, 16])

    def coverage(zoom):
        return int((render_rgb(verts, tris, cam, 64, 64, zoom=zoom) != bg).any(axis=2).sum())

    assert coverage(0.5) < coverage(1.0) < coverage(2.0)


def test_live_zoom_key_changes_pixels(tmp_path):
    frames = []

    class Grab(TerminalDisplay):
        def show(self, img, status=""):
            frames.append(img.copy())
            super().show(img, status)

    verts, tris = _two_triangles()
    LiveViewer(verts, tris, out_dir=str(tmp_path), display=Grab(stream=io.StringIO()),
               key_source=iter(["+", "q"])).run()
    assert len(frames) >= 2 and not np.array_equal(frames[0], frames[1])


def test_escape_quits(tmp_path):
    v, _ = _viewer(tmp_path, ["escape", "o", "q"])
    v.run()
    assert v.exports == 0


# ---- the port's glue -------------------------------------------------------

def test_view_flow_levels_equal_run(tmp_path, monkeypatch):
    """Two levels stepped by the live viewer ('a a') compute the tfield and
    coefficients of ``FlowProblem.run`` over the same two levels, bit for
    bit; the viewer's colours are the signals read back from the device."""
    prob, ref = _sphere_problem(), _sphere_problem()
    monkeypatch.setenv("MESHFLOW_LIVE", "1")
    monkeypatch.setattr("sys.stdin", io.StringIO("a a v o q\n"))
    assert view_flow(prob, out_dir=str(tmp_path), interactive=False) == 2
    res = ref.run()
    assert np.abs(res.tfield).max() > 0
    np.testing.assert_array_equal(prob.tfield.numpy(), res.tfield)
    np.testing.assert_array_equal(prob.coeffs.numpy(), res.coeffs)
    assert os.path.exists(tmp_path / "live_export_000.png")


def test_optical_flow_cli_without_out_runs_the_viewer(tmp_path, monkeypatch):
    """No --out launches the viewer (the reference's apps/optical_flow.py:124-
    127): headless, one frame per level into the working directory."""
    from meshopticalflow_tpu_torch.apps.optical_flow import main

    monkeypatch.chdir(tmp_path)
    assert main(["--in", os.path.join(GOLD, "a.ply"), os.path.join(GOLD, "b.ply"),
                 "--iterations", "2", "--dtype", "float64", "--device", "cpu"]) == 0
    assert sorted(os.listdir(tmp_path)) == ["artifacts", "camera.json", "level_000.png",
                                            "level_001.png", "level_002.png"]


def test_spectrum_cli_view_writes_frames(tmp_path):
    """Spectrum --view DIR renders every eigenvector field (the reference's
    apps/spectrum.py:115-118) beside the --outPrefix dumps."""
    from meshopticalflow_tpu_torch.apps.spectrum import main

    view = tmp_path / "view"
    assert main(["--mesh", os.path.join(GOLD, "cube.ply"), "--eLength", "0.2",
                 "--eigenVectors", "3", "--outPrefix", str(tmp_path / "bins"),
                 "--dtype", "float64", "--device", "cpu", "--view", str(view)]) == 0
    assert sorted(os.listdir(view)) == ["camera.json", "eigenfield_001.png",
                                        "eigenfield_002.png", "eigenfield_003.png"]
    assert len(os.listdir(tmp_path / "bins")) == 3


def test_live_viewers_run_without_matplotlib(tmp_path, monkeypatch):
    """The live terminal path is numpy only: view_flow and view_spectrum
    step, page and draw frames where matplotlib does not import (as on a
    machine that has torch and numpy only)."""
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setenv("MESHFLOW_LIVE", "1")
    frames = io.StringIO()
    monkeypatch.setattr("sys.stdout", frames)
    monkeypatch.setattr("sys.stdin", io.StringIO("a v q\n"))
    assert view_flow(_sphere_problem(), out_dir=str(tmp_path), interactive=False) == 1
    tris, verts = make_sphere_mesh(2)
    monkeypatch.setattr("sys.stdin", io.StringIO("n b q\n"))
    assert view_spectrum(verts, tris, np.zeros((2, len(tris), 2)), out_dir=str(tmp_path),
                         interactive=False) == 2
    assert frames.getvalue().count("\x1b[H") == 6
    with pytest.raises(ImportError):
        render_surface(verts, tris, str(tmp_path / "x.png"))


def test_viewer_refuses_more_than_one_rank(tmp_path):
    """The viewer runs in one process: without --out, a problem that is one
    rank of two refuses before stepping a level."""
    from meshopticalflow_tpu_torch.apps.optical_flow import _run_one, build_parser, \
        config_from_args
    from meshopticalflow_tpu_torch.parallel.distributed import DeviceGroup

    args = build_parser().parse_args(["--in", os.path.join(GOLD, "a.ply"),
                                      os.path.join(GOLD, "b.ply"), "--device", "cpu"])
    with pytest.raises(ValueError, match="one process"):
        _run_one(args, config_from_args(args), DeviceGroup(None, 0, 2, torch.device("cpu")))
