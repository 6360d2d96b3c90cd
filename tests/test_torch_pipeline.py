"""The PyTorch port's pipeline and CLI against the reference package.

* One level step from the reference package's state (carried over by
  meshopticalflow_tpu_torch.convert) against the reference level step.
* Ten levels of both packages on the 256^2 cube with use_multigrid=False:
  equal flow and smoothing iteration counts, alignment errors within 1e-9.
* The CLI's default multigrid configuration on the 256^2 cube in float64
  against the JAX package's own multigrid run (its XLA backend on the CPU:
  another cycle, so results and not iteration counts are compared),
  alignment errors per level within 1e-6 relative; and the first levels of
  the float32 run at 24,576 triangles and 512^2.
* The port's CLI (multigrid by default) on the CPU in float64 against the
  eight reference-binary goldens of tests/test_golden.py (the five of the
  other bases included), at that file's thresholds.
* --hostSolve, --debug and --serve against the reference package's.
* The port imports neither jax nor flax, and no source of the port or of
  chip_smoke.py names them in an import.
"""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meshopticalflow_tpu.config import FlowConfig as JaxFlowConfig
from meshopticalflow_tpu.flow import pipeline as j_pipeline
from meshopticalflow_tpu.geometry.mesh import build_mesh as j_build_mesh
from meshopticalflow_tpu.utils.testing import sphere_signal_pair
from meshopticalflow_tpu_torch import convert
from meshopticalflow_tpu_torch.apps.optical_flow import main as port_main
from meshopticalflow_tpu_torch.config import FlowConfig
from meshopticalflow_tpu_torch.flow import pipeline as t_pipeline
from meshopticalflow_tpu_torch.geometry.mesh import build_mesh as t_build_mesh
from meshopticalflow_tpu_torch.io.ply import read_triangle_mesh
from meshopticalflow_tpu_torch.io.png import read_png_rgb

# One intra-op thread: torch's CPU reductions then sum in one order on every
# machine and under any number of test workers.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _artifact_dir(tmp_path, monkeypatch):
    """The CLIs run with the artifact cache on (their default): keep its
    files under the test's own directory."""
    monkeypatch.setenv("MESHFLOW_CACHE", str(tmp_path / "artifacts"))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "golden")


def _configs(**kw):
    kw = dict(dtype="float64", use_multigrid=False, **kw)
    return JaxFlowConfig(artifact_cache=False, **kw), FlowConfig(artifact_cache=False, **kw)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _sphere_problems(levels):
    cfg_j, cfg_t = _configs(levels=levels)
    tris, verts, s0, s1 = sphere_signal_pair(3, angle=0.12)
    sig = np.stack([s0, s1])
    jp = j_pipeline.FlowProblem(cfg_j, j_build_mesh(tris, vertices=verts), sig,
                                vertices=verts, vertex_colors=sig)
    tp = t_pipeline.FlowProblem(cfg_t, t_build_mesh(tris, vertices=verts), sig,
                                vertices=verts, vertex_colors=sig, device="cpu")
    return jp, tp


def test_level_step_from_reference_state():
    jp, tp = _sphere_problems(levels=2)
    jp.run()                                  # reference state after two levels
    convert.load_state(tp, jp)
    cfg = jp.config
    s_w = cfg.scalar_smooth_weight * cfg.scalar_weight_multiplier ** 2
    v_w = cfg.resolved_vf_smooth_weight()
    c_j, f_j, m_j, _ = j_pipeline._level_step(
        jp.arrays, jp.coeffs, jp.tfield, jnp.asarray(s_w), jnp.asarray(v_w), cfg,
        compact_trace=True)
    c_t, f_t, m_t, _ = t_pipeline._level_step(
        tp.arrays, tp.coeffs, tp.tfield, s_w, v_w, tp.config)
    assert np.abs(np.asarray(f_j)).max() > 0
    assert _rel(c_t.numpy(), c_j) <= 1e-10
    assert _rel(f_t.numpy(), f_j) <= 1e-10
    for key in ("flow_iters", "smooth_iters", "trace_exhausted"):
        assert m_t[key] == m_j[key], key
    assert _rel(m_t["alignment_error"], m_j["alignment_error"]) <= 1e-10


def test_checkpoint_from_reference_resumes(tmp_path):
    """A reference checkpoint loads into the port, and the port's resumed
    levels match the reference's uninterrupted ones."""
    jp, tp = _sphere_problems(levels=3)
    ref = jp.run(checkpoint_dir=str(tmp_path / "ref"))
    resume_dir = tmp_path / "port"
    resume_dir.mkdir()
    shutil.copy(tmp_path / "ref" / "level_000.npz", resume_dir / "level_000.npz")
    level, s_w, v_w = convert.load_checkpoint(tp, str(resume_dir / "level_000.npz"))
    assert (level, s_w) == (0, jp.config.scalar_smooth_weight * 0.25)
    out = tp.run(checkpoint_dir=str(resume_dir))
    assert [m["level"] for m in out.metrics] == [1, 2]
    for m_t, m_j in zip(out.metrics, ref.metrics[1:]):
        assert m_t["flow_iters"] == m_j["flow_iters"]
        assert _rel(m_t["alignment_error"], m_j["alignment_error"]) <= 1e-9
    assert _rel(out.tfield, ref.tfield) <= 1e-9


@pytest.fixture(scope="module")
def cube256():
    cfg_j, cfg_t = _configs(subdivide_edge_length=0.06)
    paths = (os.path.join(GOLD, "mA.png"), os.path.join(GOLD, "mB.png"))
    jp = j_pipeline.FlowProblem.from_texture_inputs(os.path.join(GOLD, "cube.ply"),
                                                    paths, cfg_j)
    tp = t_pipeline.FlowProblem.from_texture_inputs(os.path.join(GOLD, "cube.ply"),
                                                    paths, cfg_t, device="cpu")
    return jp, jp.run(), tp, tp.run()


def test_ten_levels_match_reference(cube256):
    _, ref, _, ours = cube256
    assert len(ours.metrics) == len(ref.metrics) == 10
    for m_t, m_j in zip(ours.metrics, ref.metrics):
        for key in ("flow_iters", "smooth_iters", "trace_exhausted"):
            assert m_t[key] == m_j[key], (m_t["level"], key)
        assert _rel(m_t["alignment_error"], m_j["alignment_error"]) <= 1e-9
    assert _rel(ours.tfield, ref.tfield) <= 1e-9


def test_halfway_texture_from_reference_state(cube256):
    """From the reference's final state, with the port's own texel table
    (both packages rasterize with the same native library, so the tables
    agree), the port's halfway texture matches the reference's to one u8
    level. The truncating cast flips a texel by one level where the bilinear
    blend lands within a few ulps of an integer (flat-colour regions) and
    the two packages round the four-term blend differently (XLA contracts
    it to FMAs): 0.8 % of the texels at this size."""
    jp, _, tp, _ = cube256
    assert tp.init_profile["raster_path"] == "native"
    np.testing.assert_array_equal(tp.src_t.numpy(), np.asarray(jp.src_t))
    np.testing.assert_allclose(tp.src_p.numpy(), np.asarray(jp.src_p), rtol=0, atol=1e-12)
    convert.load_state(tp, jp, texel_table=False)
    ours, ref = tp.halfway_texture(), np.asarray(jp.halfway_texture())
    diff = np.abs(ours.astype(int) - ref.astype(int))
    assert ours.shape == ref.shape == (256, 256, 3) and ours.dtype == np.uint8
    assert diff.max() <= 1
    assert (diff == 0).all(-1).mean() >= 0.98


def _cli(tmp_path, args):
    out = str(tmp_path / ("out.png" if "--mesh" in args else "out.ply"))
    assert port_main(args + ["--out", out, "--dtype", "float64", "--device", "cpu"]) == 0
    return out


def test_cli_golden_vertex(tmp_path):
    out = _cli(tmp_path, ["--in", os.path.join(GOLD, "a.ply"), os.path.join(GOLD, "b.ply")])
    ours = read_triangle_mesh(out).colors
    ref = read_triangle_mesh(os.path.join(GOLD, "ref_vertex.ply")).colors
    assert np.array_equal(ours, ref)


@pytest.mark.parametrize("flags,fixture,max_lvl", [
    (["--vfMode", "1"], "ref_vertex_conformal.ply", 0),
    (["--vfMode", "2"], "ref_vertex_connection.ply", 0),
    (["--vfMode", "2", "--cMode", "1"], "ref_vertex_cmode1.ply", 1),
    (["--vfMode", "2", "--cMode", "2"], "ref_vertex_cmode2.ply", 1),
    (["--vfMode", "1", "--divFree"], "ref_vertex_divfree.ply", 1),
])
def test_cli_golden_vertex_all_bases(tmp_path, flags, fixture, max_lvl):
    """The five reference-binary goldens of the other bases
    (tests/test_golden.py:48-72) through the port's CLI in float64, at that
    file's thresholds, with one exception: a channel whose float64 blend
    lies within 1e-9 of an integer (a knife edge: the two advected colours
    sum to an even integer) may land one level below the golden. The port
    and the JAX package agree to ~1e-13 in the blend (their reductions sum
    in other orders), which decides such a channel; ref_vertex_connection.ply
    has one (vertex 57, blue: 51.0 in the golden)."""
    argv = ["--in", os.path.join(GOLD, "a.ply"), os.path.join(GOLD, "b.ply")] + flags
    ours = read_triangle_mesh(_cli(tmp_path, argv)).colors.astype(int)
    ref = read_triangle_mesh(os.path.join(GOLD, fixture)).colors.astype(int)
    off = np.abs(ours - ref) > max_lvl
    if off.any():
        from meshopticalflow_tpu_torch.apps.optical_flow import build_parser, config_from_args

        cfg = config_from_args(build_parser().parse_args(
            argv + ["--out", "x.ply", "--dtype", "float64"]))
        prob = t_pipeline.FlowProblem.from_vertex_inputs(argv[1], argv[2], cfg, device="cpu")
        prob.run()
        adv = prob.advected_vertex_colors()
        blend = (adv[0] + adv[1]) / 2.0
        knife = np.abs(blend - np.round(blend)) < 1e-9
        assert np.array_equal(np.clip(blend, 0, 255).astype(np.uint8), ours)
        assert np.abs(ours - ref).max() <= max_lvl + 1
        assert not (off & ~knife).any(), np.argwhere(off & ~knife)[:5]
        assert off.sum() <= 2


@pytest.mark.parametrize("inputs,e_length,fixture,limits", [
    (("cA.png", "cB.png"), "0.08", "ref_cube.png", (2.5, 0.95, 0.0)),
    (("mA.png", "mB.png"), "0.06", "ref_cube256.png", (2.2, 0.97, 0.995)),
])
def test_cli_golden_texture(tmp_path, inputs, e_length, fixture, limits):
    out = _cli(tmp_path, ["--mesh", os.path.join(GOLD, "cube.ply"), "--in",
                          *[os.path.join(GOLD, f) for f in inputs], "--eLength", e_length])
    ours = read_png_rgb(out).astype(float)
    ref = read_png_rgb(os.path.join(GOLD, fixture)).astype(float)
    rmse = float(np.sqrt(((ours - ref) ** 2).mean()))
    exact = float((ours == ref).all(-1).mean())
    within1 = float((np.abs(ours - ref) <= 1).all(-1).mean())
    max_rmse, min_exact, min_within1 = limits
    assert rmse < max_rmse, rmse
    assert exact > min_exact, exact
    assert within1 > min_within1, within1


def test_cli_cuda_without_gpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_main(["--in", os.path.join(GOLD, "a.ply"), os.path.join(GOLD, "b.ply"),
                   "--out", str(tmp_path / "x.ply"), "--device", "cuda"])


def test_port_refuses_multigrid_config():
    """A flow backend neither package has is refused at construction; the
    sharded halo cycle, ported, is not."""
    tris, verts, s0, s1 = sphere_signal_pair(2)
    mesh, sig = t_build_mesh(tris, vertices=verts), np.stack([s0, s1])
    with pytest.raises(NotImplementedError):
        t_pipeline.FlowProblem(FlowConfig(flow_backend="tiles"), mesh, sig, device="cpu")
    t_pipeline.FlowProblem(FlowConfig(flow_backend="halo"), mesh, sig, device="cpu")


def _mg_problems(dtype, edge, levels, paths):
    kw = dict(dtype=dtype, subdivide_edge_length=edge, levels=levels)
    mesh = os.path.join(GOLD, "cube.ply")
    jp = j_pipeline.FlowProblem.from_texture_inputs(
        mesh, paths, JaxFlowConfig(artifact_cache=False, **kw))
    tp = t_pipeline.FlowProblem.from_texture_inputs(
        mesh, paths, FlowConfig(artifact_cache=False, **kw), device="cpu")
    return jp, jp.run(), tp, tp.run()


def test_multigrid_default_matches_reference_f64():
    """The CLI default (use_multigrid=True) on the 0.06 cube, 256^2, float64."""
    paths = (os.path.join(GOLD, "mA.png"), os.path.join(GOLD, "mB.png"))
    jp, ref, tp, ours = _mg_problems("float64", 0.06, 10, paths)
    assert tp.hier is not None and tp.hier.patch.mg_pack.n1 > 0
    assert len(ours.metrics) == len(ref.metrics) == 10
    for m_t, m_j in zip(ours.metrics, ref.metrics):
        assert _rel(m_t["alignment_error"], m_j["alignment_error"]) <= 1e-6, m_t["level"]
        assert m_t["flow_res"] <= 10 * tp.config.flow_refine_tol
        assert m_t["flow_gb_per_iter"] > 0 and m_t["smooth_gb_per_iter"] > 0
    assert _rel(ours.tfield, ref.tfield) <= 1e-5
    for key in ("coarse_space", "mg_pack_flow", "c1_band_flow", "mg_pack_smooth"):
        assert key in tp.init_profile


def test_multigrid_default_f32_at_24k_triangles(tmp_path):
    """float32 at 24,576 triangles with the textures upsampled to 512^2, the
    first two levels: both packages' alignment errors within 1e-5."""
    from meshopticalflow_tpu_torch.io.png import write_png_rgb

    paths = []
    for name in ("mA.png", "mB.png"):
        img = read_png_rgb(os.path.join(GOLD, name))
        path = str(tmp_path / name)
        write_png_rgb(path, np.repeat(np.repeat(img, 2, axis=0), 2, axis=1))
        paths.append(path)
    jp, ref, tp, ours = _mg_problems("float32", 0.024, 2, tuple(paths))
    assert tp.mesh.n_triangles == 24576
    errs = [(m_t["alignment_error"], m_j["alignment_error"])
            for m_t, m_j in zip(ours.metrics, ref.metrics)]
    print("alignment errors (port, reference):", errs)
    for a, b in errs:
        assert _rel(a, b) <= 1e-5


def test_port_imports_no_jax():
    code = (
        "import pkgutil, importlib, sys\n"
        "import meshopticalflow_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax',"
        " 'meshopticalflow_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules if k.startswith(pkg.__name__)]))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith("ok")


_FOREIGN_IMPORT = re.compile(
    r"^\s*(?:from|import)\s+(?:jax|jaxlib|flax|meshopticalflow_tpu)(?:[\s.,]|$)", re.M)


def test_port_sources_import_no_jax():
    """Every source of the port, chip_smoke.py and the march_sweep.py it
    imports, scanned for an import of jax, flax or the JAX package (lazy
    imports inside functions included)."""
    pkg = os.path.join(REPO, "meshopticalflow_tpu_torch")
    sources = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "march_sweep.py")]
    for root, _, files in os.walk(pkg):
        sources += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(sources) > 30
    for module in ("native/__init__.py", "utils/artifacts.py", "utils/devcache.py",
                   "solvers/multifrontal.py"):
        assert os.path.join(pkg, module) in sources
    bad = {}
    for path in sources:
        with open(path) as f:
            hits = _FOREIGN_IMPORT.findall(f.read())
        if hits:
            bad[os.path.relpath(path, REPO)] = hits
    assert not bad, bad
    assert _FOREIGN_IMPORT.search("    from meshopticalflow_tpu.ops import ell\n")
    assert not _FOREIGN_IMPORT.search("from meshopticalflow_tpu_torch.ops import ell\n")


def test_host_solve_matches_reference():
    """use_host_cholesky (--hostSolve): scipy's direct solve of each level's
    float64 system on the host, zero iterations, against the reference's."""
    tris, verts, s0, s1 = sphere_signal_pair(3, angle=0.12)
    sig = np.stack([s0, s1])
    cfg_j, cfg_t = _configs(levels=3, use_host_cholesky=True)
    ref = j_pipeline.FlowProblem(cfg_j, j_build_mesh(tris, vertices=verts), sig,
                                 vertices=verts, vertex_colors=sig).run()
    ours = t_pipeline.FlowProblem(cfg_t, t_build_mesh(tris, vertices=verts), sig,
                                  vertices=verts, vertex_colors=sig, device="cpu").run()
    for m_t, m_j in zip(ours.metrics, ref.metrics):
        assert m_t["flow_iters"] == m_j["flow_iters"] == 0
        assert _rel(m_t["alignment_error"], m_j["alignment_error"]) <= 1e-9
    assert _rel(ours.tfield, ref.tfield) <= 1e-9


def test_debug_dumps_match_reference(tmp_path, monkeypatch):
    """--debug writes the reference's per-level resampled.{S,T}.<level>.ply
    set into the working directory, with the reference's colours (float64)."""
    argv = ["--in", os.path.join(GOLD, "a.ply"), os.path.join(GOLD, "b.ply"),
            "--iterations", "2", "--debug"]
    monkeypatch.chdir(tmp_path)
    _cli(tmp_path, argv)
    cfg_j, _ = _configs(levels=2)
    jp = j_pipeline.FlowProblem.from_vertex_inputs(argv[1], argv[2], cfg_j)
    jp.run(debug_dir=str(tmp_path / "ref"))
    names = sorted(f for f in os.listdir(tmp_path) if f.startswith("resampled."))
    assert names == sorted(os.listdir(tmp_path / "ref"))
    assert names == [f"resampled.{t}.{lvl}.ply" for t in "ST" for lvl in (0, 1)]
    for name in names:
        ours = read_triangle_mesh(str(tmp_path / name))
        ref = read_triangle_mesh(str(tmp_path / "ref" / name))
        np.testing.assert_array_equal(ours.colors, ref.colors)
        np.testing.assert_array_equal(ours.faces, ref.faces)


def test_serve_runs_jobs_then_quits(tmp_path):
    """--serve: a ready line, one result line per job (a bad job reports an
    error and the loop goes on), and {"cmd": "quit"} ends it."""
    import io
    import json

    from meshopticalflow_tpu_torch.apps.optical_flow import build_parser, serve

    a, b = os.path.join(GOLD, "a.ply"), os.path.join(GOLD, "b.ply")
    jobs = [{"in": [a, b], "out": str(tmp_path / "one.ply"), "iterations": 1},
            {"in": [a, b], "out": str(tmp_path / "two.ply"), "iterations": 2,
             "vfMode": 2},
            {"out": str(tmp_path / "none.ply")},
            {"cmd": "quit"},
            {"in": [a, b], "out": str(tmp_path / "after.ply")}]
    out = io.StringIO()
    base = build_parser().parse_args(["--serve", "--dtype", "float64", "--device", "cpu"])
    assert serve(base, stdin=io.StringIO("\n".join(map(json.dumps, jobs)) + "\n"),
                 stdout=out) == 0
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    assert lines[0] == {"ready": True} and len(lines) == 4
    for rec, name in zip(lines[1:3], ("one.ply", "two.ply")):
        assert rec["out"] == str(tmp_path / name) and rec["alignment_error"] > 0
        assert read_triangle_mesh(rec["out"]).colors.shape == (66, 3)
    assert "error" in lines[3]
    assert not (tmp_path / "after.ply").exists()
