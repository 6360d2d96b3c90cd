"""A benchmark root at a size the CPU holds, for the CPU tests: a copy of
portbench/ beside a BENCHMARK.json whose cells run the 12-triangle golden
cube at a 64^2 atlas, three levels, edge length 0.1 (a few hundred
triangles), with the series and frames mixes. Its limits were set from
CPU readings at this size: the program's flow 1.7e-5 to 6.3e-3 from the
float64 reference over 15 seeds and its blend 0.21 to 0.40 levels; the
control's 0.107 to 0.158 and 5.0 to 6.2 levels."""

from __future__ import annotations

import copy
import json
import os
import shutil
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
TINY_LIMITS = {"tfield_gap": 0.03, "halfway_mad": 1.5}


def paths() -> None:
    for p in (BENCH, REPO):
        if p not in sys.path:
            sys.path.insert(0, p)


def make_root(tmp) -> str:
    """A checkout-like root under ``tmp``: BENCHMARK.json with the tiny
    cells added, and portbench/ with the tiny configuration. Returns it."""
    root = str(tmp)
    bench_dir = os.path.join(root, "portbench")
    shutil.copytree(BENCH, bench_dir, ignore=shutil.ignore_patterns("_cache", "__pycache__",
                                                                   "tests"))
    with open(os.path.join(BENCH, "configs", "whitney-tex2048.json")) as f:
        conf = json.load(f)
    conf.update(name="tiny", root_mesh="data/cube.ply", atlas=64, limits=dict(TINY_LIMITS))
    conf["flags"].update(eLength=0.1, iterations=3)
    conf["frames"]["displacement_texels"] = 2.0
    with open(os.path.join(bench_dir, "configs", "tiny.json"), "w") as f:
        json.dump(conf, f)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench = copy.deepcopy(bench)
    bench["configs"].append({"name": "tiny", "source": "tests", "reduced": [], "why": "tests",
                             "file": "portbench/configs/tiny.json"})
    bench["workloads"] += [
        {"name": "tiny.series", "config": "tiny", "traffic": "series", "chips": 1, "why": "t"},
        {"name": "tiny.frames", "config": "tiny", "traffic": "frames", "chips": 1, "why": "t"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += ["tiny." + w.split(".")[1] for w in list(m["workloads"])]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def cell(root: str, name: str):
    paths()
    from pbcore.spec import load_cell

    return load_cell(root, name, os.path.join(root, "portbench"))
