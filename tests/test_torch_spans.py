"""The port's span and counter store (meshopticalflow_tpu_torch/utils/spans.py)
and the spans the program opens where its work happens.

* Off (no profiler, no MESHFLOW_SPANS): ``span`` returns one shared no-op
  context and makes no clock read, profiler call, record or synchronize; a
  ``timed`` span reads the host clock and synchronizes only with
  ``always_sync``.
* On under ``torch.profiler.profile``: every span is a user annotation of
  the profiler whose start lies within 1 ms of the record's, with its
  parent and self time; the record keeps at most MAX_SPANS spans.
* A CPU texture pair records the tree init > init.*, run > level >
  level.* > mg.c1_solve, halfway > halfway.*, all under one job id; with
  the record off it still reports init_profile and the levels' stage
  seconds, and its init spans ask for no synchronize.
* The kernel modules' launch counters live in the store; each module's
  counts() / reset_counts() see their own entries only.
"""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from meshopticalflow_tpu_torch.config import FlowConfig
from meshopticalflow_tpu_torch.flow import pipeline
from meshopticalflow_tpu_torch.kernels import banded, probes, spmv, tracing
from meshopticalflow_tpu_torch.utils import devcache, spans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "golden")
MESH = os.path.join(GOLD, "cube.ply")
PATHS = (os.path.join(GOLD, "cA.png"), os.path.join(GOLD, "cB.png"))
CFG = FlowConfig(subdivide_edge_length=0.08, levels=3)
INIT_KEYS = {"device_tables", "basis", "coarse", "preprocess_signals", "exp_remap", "geom",
             "decode", "bake", "raster", "raster_path"}
STAGE_KEYS = {"smooth_seconds", "trace_seconds", "solve_seconds"}


@pytest.fixture
def clean(monkeypatch):
    """An empty record, recording off."""
    monkeypatch.setattr(spans, "_PATH", None)
    spans.reset()
    yield
    spans.reset()


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("MESHFLOW_CACHE", str(tmp_path / "artifacts"))
    devcache.clear()
    yield
    devcache.clear()


def _counting(monkeypatch, obj, name):
    calls = []
    real = getattr(obj, name)

    def counted(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(obj, name, counted)
    return calls


def _pair():
    prob = pipeline.FlowProblem.from_texture_inputs(MESH, PATHS, CFG, device="cpu")
    res = prob.run()
    prob.halfway_texture()
    return prob, res


def test_off_span_is_one_shared_noop(clean, monkeypatch):
    syncs = _counting(monkeypatch, torch.cuda, "synchronize")
    marks = _counting(monkeypatch, torch.profiler, "record_function")
    clock = _counting(monkeypatch, spans.time, "time_ns")
    assert not spans.recording()
    contexts = {id(spans.span(name, device=True)) for name in ("a", "b", "mg.c1_solve")}
    assert contexts == {id(spans.span("c"))}
    assert spans.job(spans.new_job()) is spans.span("d")
    with spans.span("a"):
        with spans.span("b", device=True):
            pass
    assert (syncs, marks, clock) == ([], [], [])
    assert spans.totals()["spans"] == {} and spans.records() == []


@pytest.mark.parametrize("on,always,want", [(False, False, 0), (False, True, 1),
                                            (True, False, 1), (True, True, 1)])
def test_timed_reads_the_clock_and_syncs_as_asked(clean, monkeypatch, tmp_path, on, always,
                                                  want):
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: syncs.append(dev))
    if on:
        monkeypatch.setattr(spans, "_PATH", str(tmp_path / "spans.jsonl"))
    with spans.timed("t", sync=torch.device("cuda", 0), always_sync=always) as t:
        time.sleep(0.002)
    assert t.seconds >= 0.002
    assert len(syncs) == want
    with spans.timed("host", sync=torch.device("cpu"), always_sync=True):
        pass
    assert len(syncs) == want
    assert set(spans.totals()["spans"]) == ({"t", "host"} if on else set())


def test_spans_are_profiler_annotations_on_its_clock(clean):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert spans.recording()
        with spans.span("outer"):
            with spans.span("inner", device=True):
                time.sleep(0.001)
            with spans.timed("clocked"):
                pass
    assert not spans.recording()
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in ("outer", "inner", "clocked"):
            assert e.is_user_annotation()
            events.setdefault(e.name(), []).append(e)
    recs = spans.records()
    assert sorted(r["name"] for r in recs) == ["clocked", "inner", "outer"]
    for r in recs:
        (e,) = events[r["name"]]
        assert abs(e.start_ns() - r["start_ns"]) < 1_000_000
        assert "device_s" not in r      # no CUDA on this machine


def test_parent_and_self_time(clean, tmp_path, monkeypatch):
    monkeypatch.setattr(spans, "_PATH", str(tmp_path / "spans.jsonl"))
    with spans.span("parent"):
        time.sleep(0.01)
        for _ in range(2):
            with spans.span("child"):
                time.sleep(0.01)
    recs = {r["name"]: r for r in spans.records()}
    assert recs["child"]["parent"] == recs["parent"]["id"] and recs["parent"]["parent"] is None
    tot = spans.totals()["spans"]
    assert tot["child"]["count"] == 2 and tot["parent"]["count"] == 1
    assert tot["child"]["self_seconds"] == pytest.approx(tot["child"]["seconds"])
    assert tot["parent"]["self_seconds"] == pytest.approx(
        tot["parent"]["seconds"] - tot["child"]["seconds"])
    assert 0.009 < tot["parent"]["self_seconds"] < tot["parent"]["seconds"] - 0.019


def test_record_keeps_at_most_max_spans(clean, tmp_path, monkeypatch):
    monkeypatch.setattr(spans, "_PATH", str(tmp_path / "spans.jsonl"))
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: spans._OFF)      # the bound alone, quickly
    extra = 7
    for i in range(spans.MAX_SPANS + extra):
        with spans.span("s"):
            pass
    recs = spans.records()
    assert len(recs) == spans.MAX_SPANS
    assert spans.counter("spans.dropped") == extra
    assert recs[0]["id"] == recs[-1]["id"] - spans.MAX_SPANS + 1   # the oldest went


def test_meshflow_spans_writes_the_record_at_exit(tmp_path):
    out = tmp_path / "spans.jsonl"
    code = ("from meshopticalflow_tpu_torch.utils import spans\n"
            "with spans.job(spans.new_job()), spans.span('a'):\n"
            "    with spans.span('b'):\n"
            "        spans.count('n', 3)\n")
    env = dict(os.environ, MESHFLOW_SPANS=str(out), PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=120)
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert [d.get("name") for d in lines[:2]] == ["b", "a"]
    assert lines[0]["parent"] == lines[1]["id"] and lines[0]["job"] == lines[1]["job"] == 1
    assert lines[-1] == {"counters": {"n": 3}}


def test_texture_pair_records_the_span_tree(clean, cache_dir):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        prob, res = _pair()
    recs = spans.records()
    by_id = {r["id"]: r for r in recs}

    def path(r):
        names = [r["name"]]
        while r["parent"] is not None:
            r = by_id[r["parent"]]
            names.append(r["name"])
        return ">".join(reversed(names))

    paths = {path(r) for r in recs}
    for want in ("init>init.geometry", "init>init.decode", "init>init.bake",
                 "init>init.bake>artifact.write", "init>init.raster",
                 "init>init.tables>init.device_tables", "init>init.tables>init.basis",
                 "init>init.tables>init.coarse", "init>init.signals",
                 "init>init.signals>mg.c1_factor", "init>init.signals>mg.c1_solve",
                 "init>init.textures", "init>init.texels",
                 "run>level>level.smooth", "run>level>level.trace",
                 "run>level>level.solve>mg.c1_factor", "run>level>level.solve>mg.c1_solve",
                 "halfway>halfway.march", "halfway>halfway.fetch", "halfway>halfway.tail",
                 "halfway>halfway.copy"):
        assert want in paths, (want, sorted(paths))
    assert {r["job"] for r in recs} == {prob.job}
    tot = spans.totals()
    assert tot["spans"]["level"]["count"] == CFG.levels
    assert tot["spans"]["init"]["count"] == tot["spans"]["run"]["count"] == 1
    assert tot["counters"]["halfway.copies"] == 1
    assert tot["counters"]["halfway.copy_bytes"] == 3 * prob.texture_source.width \
        * prob.texture_source.height
    assert prob.init_profile["decode"] == pytest.approx(
        tot["spans"]["init.decode"]["seconds"])
    assert [m["solve_seconds"] for m in res.metrics] == pytest.approx(
        [r["end_ns"] * 1e-9 - r["start_ns"] * 1e-9 for r in recs
         if r["name"] == "level.solve"], abs=1e-6)


def test_texture_pair_reports_its_clocks_with_the_record_off(clean, cache_dir, monkeypatch):
    asked = []
    real = spans.timed

    def timed(name, sync=None, always_sync=False):
        asked.append((name, always_sync))
        return real(name, sync, always_sync)

    monkeypatch.setattr(spans, "timed", timed)
    syncs = (_counting(monkeypatch, pipeline, "_sync"),
             _counting(monkeypatch, torch.cuda, "synchronize"))
    prob, res = _pair()
    assert syncs == ([], [])
    assert spans.records() == [] and spans.totals()["spans"] == {}
    assert set(prob.init_profile) >= INIT_KEYS
    assert all(prob.init_profile[k] >= 0 for k in INIT_KEYS - {"raster_path"})
    for m in res.metrics:
        assert STAGE_KEYS <= set(m) and all(m[k] > 0 for k in STAGE_KEYS)
    always = {name for name, a in asked if a}
    assert always == {"level.smooth", "level.trace", "level.solve"}
    assert {name for name, _ in asked if name.startswith("init.")} >= {
        "init.geometry", "init.decode", "init.bake", "init.raster", "init.tables",
        "init.signals", "init.textures", "init.texels"}
    assert spans.counter("halfway.copies") == 1


def test_launch_counters_are_views_of_the_store(clean):
    spans.count("launch.spmv_ell/f32/square/slab", 2)
    spans.count("launch.spmv_ell_multi/f32/square/slab")
    spans.count("launch.panel_sweep/lower/f32/f32", 3)
    spans.count("launch.band_factor/f32")
    spans.count("launch.march_field")
    spans.count("launch.march_field/flow_field_trace")
    spans.count("launch.scale", 4)
    assert spmv.spmv_ell.launches == 2 and spmv.spmv_ell_multi.launches == 1
    assert spmv.counts()["by_form"] == {"spmv_ell/f32/square/slab": 2,
                                        "spmv_ell_multi/f32/square/slab": 1}
    assert banded.counts()["by_form"] == {"band_factor/f32": 1,
                                          "panel_sweep/lower/f32/f32": 3}
    assert banded.panel_sweep.launches == 3 and banded.band_factor.launches == 1
    assert tracing.counts()["march_field"] == 1
    assert tracing.counts()["by_wrapper"]["flow_field_trace"] == 1
    assert tracing.flow_field_trace.launches == 1 and probes.scale.launches == 4
    spmv.reset_counts()
    assert spmv.counts()["by_form"] == {} and banded.panel_sweep.launches == 3
    banded.reset_counts()
    tracing.reset_counts()
    probes.reset_counts()
    assert spans.totals()["counters"] == {}
    assert spmv.spmv_ell.__name__ == "spmv_ell" and probes.scale.__doc__
