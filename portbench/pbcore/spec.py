"""A cell as BENCHMARK.json names it, and the files that hold its parts,
found by name: ``configs/<config>.json`` (the config entry's ``file``),
``traffic/<traffic>.json`` (the mix's parameters), ``loops/<loop>.py``
(the kind of unit the mix's ``loop`` names) and ``metrics/<metric>.py``
(a reader for every metric, end-to-end and per-layer). A later cell,
mix, loop or metric is a new file and a new entry; no file here changes
for it."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class SpecError(ValueError):
    """BENCHMARK.json or a file it names is missing or malformed."""


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    reader: Optional[object] = None     # the module metrics/<name>.py, with read(ctx)
    layer: str = ""
    moves: str = ""


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict              # the configuration file's contents
    config_path: str
    traffic_name: str
    traffic: dict             # the traffic mix's parameters
    loop: object              # the module loops/<traffic["loop"]>.py, with Loop
    end_to_end: List[Metric]  # those this cell reports
    per_layer: List[Metric]
    bench_dir: str

    def path(self, rel: str) -> str:
        """A path the configuration gives relative to the benchmark folder."""
        return os.path.join(self.bench_dir, rel)


def _load_json(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError) as exc:
        raise SpecError(f"cannot read {path}: {exc}") from exc


def load_part(bench_dir: str, folder: str, name: str, attr: str):
    """``<folder>/<name>.py`` as a module that defines ``attr``."""
    path = os.path.join(bench_dir, folder, name + ".py")
    if not os.path.isfile(path):
        raise SpecError(f"no file {path} for {name!r}")
    key = f"pb_{folder}_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if getattr(module, attr, None) is None:
        raise SpecError(f"{path} defines no {attr}")
    return module


def load_reader(bench_dir: str, name: str):
    """``metrics/<name>.py``: it defines ``read(ctx)``."""
    return load_part(bench_dir, "metrics", name, "read")


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(root: str, workload: str, bench_dir: str = BENCH_DIR) -> Cell:
    """The cell ``workload`` of ``root``/BENCHMARK.json with its files."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench.get("workloads", [])}
    if workload not in cells:
        raise SpecError(f"no workload {workload!r} in BENCHMARK.json "
                        f"(it has {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench.get("configs", [])}
    if w["config"] not in configs:
        raise SpecError(f"workload {workload} names the unknown config {w['config']!r}")
    conf_entry = configs[w["config"]]
    conf_path = os.path.join(root, conf_entry["file"])
    traffic_path = os.path.join(bench_dir, "traffic", w["traffic"] + ".json")
    traffic = _load_json(traffic_path)
    if "loop" not in traffic:
        raise SpecError(f"{traffic_path} names no loop")
    e2e = [Metric(m["name"], m["unit"], m["better"], m["source"],
                  load_reader(bench_dir, m["name"]))
           for m in bench.get("end_to_end", []) if _applies(m, workload)]
    per_layer = [Metric(m["name"], m["unit"], m["better"], m["source"],
                        load_reader(bench_dir, m["name"]), m["layer"], m["moves"])
                 for m in bench.get("per_layer", []) if _applies(m, workload)]
    return Cell(name=workload, chips=int(w["chips"]), config_name=w["config"],
                config=_load_json(conf_path), config_path=conf_path,
                traffic_name=w["traffic"], traffic=traffic,
                loop=load_part(bench_dir, "loops", traffic["loop"], "Loop"),
                end_to_end=e2e, per_layer=per_layer, bench_dir=bench_dir)
