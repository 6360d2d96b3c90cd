"""The PyTorch port's pipeline and CLI against the reference package.

* One level step from the reference package's state (carried over by
  meshopticalflow_tpu_torch.convert) against the reference level step.
* Ten levels of both packages on the 256^2 cube with use_multigrid=False:
  equal flow and smoothing iteration counts, alignment errors within 1e-9.
* The port's CLI on the CPU in float64 against the three reference-binary
  goldens of tests/test_golden.py, at that file's thresholds.
* The port imports neither jax nor flax.
"""

import os
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "golden")


def _configs(**kw):
    kw = dict(dtype="float64", use_multigrid=False, **kw)
    return JaxFlowConfig(artifact_cache=False, **kw), FlowConfig(**kw)


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
                                vertices=verts, vertex_colors=sig)
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
                                                    paths, cfg_t)
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
    """From the reference's final state and texel table, the port's halfway
    texture matches the reference's to one u8 level. The truncating cast
    flips a texel by one level where the bilinear blend lands within a few
    ulps of an integer (flat-colour regions) and the two packages round the
    four-term blend differently (XLA contracts it to FMAs): 0.8 % of the
    texels at this size."""
    jp, _, tp, _ = cube256
    convert.load_state(tp, jp)
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
    tris, verts, s0, s1 = sphere_signal_pair(2)
    with pytest.raises(NotImplementedError):
        t_pipeline.FlowProblem(FlowConfig(), t_build_mesh(tris, vertices=verts),
                               np.stack([s0, s1]))


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
