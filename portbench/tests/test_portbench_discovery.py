"""A later cell or metric is files and BENCHMARK.json entries only: a
dropped-in configuration, traffic mix, loop of its own and metrics (one
end-to-end, one per-layer) are found by name and run, with no edit to a
file the benchmark has."""

from __future__ import annotations

import json
import os

import pytest

import portbench_tiny

portbench_tiny.paths()

LOOP = '''"""One unit: a pair of fresh frames aligned, then two halfway frames."""
import time

from pbcore import check
from pbcore.systems import to_numpy


class Loop:
    def __init__(self, run):
        self.run = run
        self.units = []

    def setup(self):
        prob = self.run.problem([0, 1])
        prob.run()
        prob.halfway_texture(0.25)

    def window(self):
        r = self.run
        k, t0 = 0, time.perf_counter()
        while k == 0 or time.perf_counter() - t0 < r.seconds:
            keys = (2 * k + 2, 2 * k + 3)
            ts = time.perf_counter()
            prob = r.problem(list(keys))
            res = prob.run()
            outs = [prob.halfway_texture(a) for a in (0.25, 0.75)]
            self.units.append(dict(keys=keys, tfield=res.tfield, out=outs[0],
                                   seconds=time.perf_counter() - ts))
            k += 1
        return k, time.perf_counter() - t0

    def release(self):
        pass

    def check(self):
        u, r = self.units[0], self.run
        tex0, tex1 = (r.frames[k][1] for k in u["keys"])
        ref = r.reference()
        tf = ref.align(tex0, tex1)
        return {"tfield_gap": check.tfield_gap(to_numpy(u["tfield"]), to_numpy(tf)),
                "halfway_mad": check.halfway_mad(u["out"], ref.halfway(tf, tex0, tex1, 0.25))}
'''


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


def test_dropped_in_config_mix_and_metric_are_found(tmp_path):
    from pbcore import session

    root = portbench_tiny.make_root(tmp_path)
    bench_dir = os.path.join(root, "portbench")
    before = {os.path.join(dp, p): open(os.path.join(dp, p), "rb").read()
              for dp, _, files in os.walk(bench_dir) for p in files}
    with open(os.path.join(bench_dir, "configs", "tiny.json")) as f:
        conf = json.load(f)
    conf["name"] = "dummy"
    _write(os.path.join(bench_dir, "configs", "dummy.json"), json.dumps(conf))
    _write(os.path.join(bench_dir, "traffic", "bursty.json"),
           json.dumps({"loop": "bursts", "trace_units": 1, "why": "a dropped-in mix"}))
    _write(os.path.join(bench_dir, "loops", "bursts.py"), LOOP)
    _write(os.path.join(bench_dir, "metrics", "dummy.count.py"),
           "def read(ctx):\n    return 42.0 if ctx.cell == 'dummy.bursty' else None\n")
    _write(os.path.join(bench_dir, "metrics", "bursts_per_s.py"),
           "def read(ctx):\n    return len(ctx.units) / ctx.window_s\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "dummy", "source": "test", "reduced": [], "why": "t",
                             "file": "portbench/configs/dummy.json"})
    bench["workloads"].append({"name": "dummy.bursty", "config": "dummy", "traffic": "bursty",
                               "chips": 1, "why": "t"})
    bench["end_to_end"].append({"name": "bursts_per_s", "unit": "bursts/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["dummy.bursty"]})
    bench["per_layer"].append({"name": "dummy.count", "unit": "n", "better": "lower",
                               "source": "program_counter", "layer": "test",
                               "moves": "bursts_per_s", "workloads": ["dummy.bursty"]})
    _write(os.path.join(root, "BENCHMARK.json"), json.dumps(bench))

    cell = portbench_tiny.cell(root, "dummy.bursty")
    assert cell.config["name"] == "dummy"
    assert cell.traffic["why"] == "a dropped-in mix"
    assert cell.loop.__file__.endswith(os.path.join("loops", "bursts.py"))
    assert [m.name for m in cell.per_layer] == ["dummy.count"]
    assert cell.per_layer[0].reader.read(type("C", (), {"cell": "dummy.bursty"})) == 42.0
    # end-to-end metrics with no workloads list apply to the new cell too
    assert {m.name for m in cell.end_to_end} == {"bursts_per_s", "peak_mem_gib", "setup_s"}
    out = session.run_cell(cell, 2**31 + 5, 0.5, False, "cpu", log=lambda m: None)
    assert out["correct"] is True, out["check"]
    assert set(out["metrics"]) == {"bursts_per_s", "peak_mem_gib", "setup_s"}
    assert out["metrics"]["bursts_per_s"]["value"] > 0
    for path, data in before.items():
        assert open(path, "rb").read() == data, f"{path} changed"


@pytest.mark.parametrize("name", ["whitney-tex2048.series", "whitney-tex4096.frames"])
def test_committed_cells_load(name):
    from pbcore.spec import load_cell

    cell = load_cell(portbench_tiny.REPO, name)
    assert cell.per_layer and cell.end_to_end
    assert {m.name for m in cell.end_to_end} >= {"setup_s", "peak_mem_gib"}
    assert all(callable(m.reader.read) for m in cell.end_to_end + cell.per_layer)
    assert set(cell.config["limits"]) == {"tfield_gap", "halfway_mad"}


def test_unknown_workload_is_refused(tmp_path):
    from pbcore.spec import SpecError, load_cell

    with pytest.raises(SpecError):
        load_cell(portbench_tiny.REPO, "no.such-cell")


def test_a_mix_naming_no_loop_file_is_refused(tmp_path):
    from pbcore.spec import SpecError

    root = portbench_tiny.make_root(tmp_path)
    _write(os.path.join(root, "portbench", "traffic", "series.json"),
           json.dumps({"loop": "no_such_loop", "trace_units": 1}))
    with pytest.raises(SpecError, match="no_such_loop"):
        portbench_tiny.cell(root, "tiny.series")
