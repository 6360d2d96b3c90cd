"""The port's per-mesh init cache: utils/artifacts.py (disk) and
utils/devcache.py (device tensors), and their use by FlowProblem.

* tests/test_artifacts.py's two cases against the port's copy; the port's
  key tag differs from the reference package's.
* The device cache's LRU byte budget (tests/test_pipeline.py:287).
* A second construction of the same texture problem reuses the first one's
  tensors and reproduces its tfield and per-level alignment errors exactly
  (multigrid and mf); with MESHFLOW_DEVCACHE=0 it gets fresh tensors and
  the same numbers; a run of the first problem does not change what the
  second computes (no in-place write to shared state).
* TrackSequence writes the same bytes with the cache on and off, and its
  second pair, like a second --serve job, builds no mesh state again.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from meshopticalflow_tpu.utils import artifacts as j_artifacts
from meshopticalflow_tpu_torch.config import FlowConfig
from meshopticalflow_tpu_torch.flow import pipeline as t_pipeline
from meshopticalflow_tpu_torch.utils import artifacts, devcache

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "golden")
MESH = os.path.join(GOLD, "cube.ply")
PATHS = (os.path.join(GOLD, "cA.png"), os.path.join(GOLD, "cB.png"))


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("MESHFLOW_CACHE", str(tmp_path / "artifacts"))
    devcache.clear()
    yield tmp_path / "artifacts"
    devcache.clear()


def test_cached_roundtrip_with_csr(cache_dir):
    calls = []

    def compute():
        calls.append(1)
        return dict(a=np.arange(6).reshape(2, 3), m=sp.csr_matrix(np.eye(3)))

    d1 = artifacts.cached("t", "k1", compute)
    d2 = artifacts.cached("t", "k1", compute)
    assert len(calls) == 1
    np.testing.assert_array_equal(d2["a"], d1["a"])
    assert (d2["m"] != d1["m"]).nnz == 0
    assert os.listdir(cache_dir) == ["t-k1.npz"]


def test_cached_lazy_keys_defer_payload(cache_dir):
    big = np.arange(1000, dtype=np.float32).reshape(100, 10)

    def compute():
        return dict(small=np.ones(3), big=big)

    d0 = artifacts.cached("t", "k2", compute, lazy_keys=("big",))
    assert isinstance(d0["big"], np.ndarray)       # a fresh compute: the real array
    d1 = artifacts.cached("t", "k2", compute, lazy_keys=("big",))
    lz = d1["big"]
    assert isinstance(lz, artifacts.LazyNpzArray)
    assert lz.shape == (100, 10) and lz.ndim == 2
    assert np.dtype(lz.dtype) == np.float32
    np.testing.assert_array_equal(np.asarray(lz), big)
    np.testing.assert_array_equal(torch.as_tensor(np.asarray(lz)).numpy(), big)
    d2 = artifacts.cached("t", "k2", compute)
    assert isinstance(d2["big"], np.ndarray)


def test_keys_differ_from_reference_package():
    """The port's key tag is its own: an npz one package wrote is never read
    by the other under the same $MESHFLOW_CACHE."""
    assert artifacts._VERSION != j_artifacts._VERSION
    for parts in (("geom", "0123456789abcdef", 0.006), ("basis", "k", 0, 0, False)):
        assert artifacts.key_of(*parts) != j_artifacts.key_of(*parts)
        assert len(artifacts.key_of(*parts)) == 16


def test_devcache_byte_budget_evicts_lru(monkeypatch):
    """Eviction is bounded by bytes (device memory is the budget), keeping at
    least the newest entry; keys are per device."""
    devcache.clear()
    monkeypatch.setattr(devcache, "_MAX_BYTES", 3 * 1024)
    devcache.get_or_build(("a",), lambda: torch.zeros(256, dtype=torch.float64))
    b = devcache.get_or_build(("b",), lambda: torch.zeros(256, dtype=torch.float64))
    # 2 KiB each against a 3 KiB budget: "a" must have been evicted.
    assert devcache.total_bytes() == 2048
    assert devcache.get_or_build(("b",), lambda: None) is b
    assert devcache.get_or_build(("b",), lambda: "other", "meta") == "other"
    monkeypatch.setenv("MESHFLOW_DEVCACHE", "0")
    assert devcache.get_or_build(("b",), lambda: "fresh") == "fresh"
    devcache.clear()
    assert devcache.total_bytes() == 0


def _texture(cfg):
    return t_pipeline.FlowProblem.from_texture_inputs(MESH, PATHS, cfg, device="cpu")


def _same_numbers(r1, r2):
    np.testing.assert_array_equal(r1.tfield, r2.tfield)
    assert [m["alignment_error"] for m in r1.metrics] == \
        [m["alignment_error"] for m in r2.metrics]
    assert [m["flow_iters"] for m in r1.metrics] == [m["flow_iters"] for m in r2.metrics]


CONFIGS = {"multigrid": dict(), "mf": dict(flow_backend="mf")}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_warm_texture_construction_reuses_tensors(cache_dir, monkeypatch, name):
    cfg = FlowConfig(dtype="float64", subdivide_edge_length=0.08, levels=3,
                     **CONFIGS[name])
    p1 = _texture(cfg)
    r1 = p1.run()
    assert "coarse_space" in p1.init_profile
    p2 = _texture(cfg)
    # identity, not equality: the second problem holds the same tensors
    assert p2.arrays.basis.ell_cols is p1.arrays.basis.ell_cols
    assert p2.arrays.tm is p1.arrays.tm
    assert p2.src_t is p1.src_t and p2.src_p is p1.src_p
    assert p2.textures is p1.textures
    assert p2.arrays.signals is p1.arrays.signals
    assert p2.hier.coarse is p1.hier.coarse
    assert "coarse_space" not in p2.init_profile      # no hierarchy build
    assert p2.init_profile["raster_path"] == "native"
    if name == "mf":
        assert p2.nd is p1.nd
    else:
        # each problem schedules its own PCG chunks from nothing
        assert p2.hier.patch.mg_pack is not p1.hier.patch.mg_pack
        assert p2.hier.patch.mg_pack.p0 is p1.hier.patch.mg_pack.p0
        assert p2.hier.patch.mg_pack.rho == {}
    _same_numbers(r1, p2.run())

    monkeypatch.setenv("MESHFLOW_DEVCACHE", "0")
    p3 = _texture(cfg)
    assert p3.src_t is not p1.src_t and p3.arrays.basis.ell_cols is not p1.arrays.basis.ell_cols
    _same_numbers(r1, p3.run())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_run_leaves_shared_state_unchanged(cache_dir, name):
    """Run problem A, then construct and run an identical problem B on A's
    cached tensors, and hold B to a construction with no cache at all."""
    cfg = FlowConfig(dtype="float64", subdivide_edge_length=0.08, levels=2,
                     **CONFIGS[name])
    a = _texture(cfg)
    a.run()
    a.halfway_texture()
    b = _texture(cfg)
    assert b.arrays.basis.s_vals is a.arrays.basis.s_vals
    rb, blend_b = b.run(), b.halfway_texture()
    cold = _texture(dataclasses.replace(cfg, artifact_cache=False))
    rc, blend_c = cold.run(), cold.halfway_texture()
    _same_numbers(rb, rc)
    np.testing.assert_array_equal(blend_b, blend_c)


def test_vertex_problem_reuses_mesh_state(cache_dir):
    a, b = os.path.join(GOLD, "a.ply"), os.path.join(GOLD, "b.ply")
    cfg = FlowConfig(dtype="float64", levels=2)
    p1 = t_pipeline.FlowProblem.from_vertex_inputs(a, b, cfg, device="cpu")
    p2 = t_pipeline.FlowProblem.from_vertex_inputs(b, a, cfg, device="cpu")
    assert p2.mesh is p1.mesh and p2.arrays.basis is p1.arrays.basis
    cold = t_pipeline.FlowProblem.from_vertex_inputs(
        b, a, dataclasses.replace(cfg, artifact_cache=False), device="cpu")
    assert cold.mesh is not p1.mesh
    _same_numbers(p2.run(), cold.run())


def _count_builds(monkeypatch):
    calls = {"basis": 0, "tables": 0}
    real_basis, real_tables = t_pipeline.build_basis, t_pipeline.make_trace_mesh

    def basis(*args, **kw):
        calls["basis"] += 1
        return real_basis(*args, **kw)

    def tables(*args, **kw):
        calls["tables"] += 1
        return real_tables(*args, **kw)

    monkeypatch.setattr(t_pipeline, "build_basis", basis)
    monkeypatch.setattr(t_pipeline, "make_trace_mesh", tables)
    return calls


def _track(out, cache_on, monkeypatch):
    from meshopticalflow_tpu_torch.apps import optical_flow
    from meshopticalflow_tpu_torch.apps.track_sequence import main

    real = optical_flow.config_from_args
    monkeypatch.setattr(optical_flow, "config_from_args",
                        lambda args: dataclasses.replace(real(args),
                                                         artifact_cache=cache_on))
    a, b = os.path.join(GOLD, "a.ply"), os.path.join(GOLD, "b.ply")
    assert main(["--in", a, b, a, "--outDir", str(out), "--composed", "--dtype",
                 "float64", "--iterations", "3", "--device", "cpu"]) == 0
    return {name: (out / name).read_bytes() for name in sorted(os.listdir(out))
            if name != "metrics.jsonl"}


def test_track_sequence_same_bytes_with_cache_on_and_off(cache_dir, tmp_path,
                                                         monkeypatch):
    calls = _count_builds(monkeypatch)
    on = _track(tmp_path / "on", True, monkeypatch)
    assert calls == {"basis": 1, "tables": 1}      # the second pair built nothing
    off = _track(tmp_path / "off", False, monkeypatch)
    assert calls == {"basis": 3, "tables": 3}
    assert sorted(on) == sorted(off) == [
        "composed_resampled.ply", "halfway_000.ply", "halfway_001.ply",
        "vectorField_000.bin", "vectorField_001.bin"]
    for name in on:
        assert on[name] == off[name], name
    with open(tmp_path / "on" / "metrics.jsonl") as f:
        pairs = [json.loads(line) for line in f][:2]
    assert "device_tables" in pairs[1]["init_profile"]


def test_serve_jobs_over_one_mesh_share_init(cache_dir, tmp_path, monkeypatch):
    """Two --serve texture jobs over one mesh: the second builds no mesh
    tables, basis or hierarchy and writes no artifact."""
    import io

    from meshopticalflow_tpu_torch.apps.optical_flow import build_parser, serve

    calls = _count_builds(monkeypatch)
    jobs = [{"mesh": MESH, "in": list(PATHS), "out": str(tmp_path / f"{i}.png"),
             "eLength": 0.08, "iterations": 2} for i in range(2)]
    base = build_parser().parse_args(["--serve", "--dtype", "float64", "--device", "cpu"])
    out = io.StringIO()
    seen = []
    real_compute = t_pipeline._texture_geometry

    def geometry(*args):
        seen.append(sorted(os.listdir(cache_dir)) if os.path.isdir(cache_dir) else [])
        return real_compute(*args)

    monkeypatch.setattr(t_pipeline, "_texture_geometry", geometry)
    assert serve(base, stdin=io.StringIO("\n".join(map(json.dumps, jobs)) + "\n"),
                 stdout=out) == 0
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    assert len(lines) == 3 and all("error" not in x for x in lines)
    assert calls == {"basis": 1, "tables": 1} and len(seen) == 1
    tags = {name.split("-")[0] for name in os.listdir(cache_dir)}
    assert {"geom", "bake", "basis", "coarse", "sigpre"} <= tags
    assert (tmp_path / "0.png").read_bytes() == (tmp_path / "1.png").read_bytes()
