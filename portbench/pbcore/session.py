"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

The cell's loop (loops/<loop>.py, named by its traffic mix) does the work:
``setup()`` makes the inputs from the seed and warms every shape the window
uses, ``window()`` records its units and returns their count and the
window's seconds, ``release()`` frees the system's state, ``check()``
returns the numbers compared with the plain reference. The artifact cache
points into the run's temporary directory, so every run pays the mesh's
cold init in set-up. The window starts no unit after ``seconds`` and
finishes the one in flight. Every metric, end-to-end or per-layer, is
read from a Context by its reader (metrics/<name>.py). The reference runs
after the window, once the peak memory is read and the system's state is
freed."""

from __future__ import annotations

import gc
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from pbcore import check, hooks
from pbcore.inputs import FrameMaker, digest, read_png, write_pngs
from pbcore.profiling import Tracer
from pbcore.spec import Cell, SpecError
from pbcore.systems import SYSTEMS

_REFERENCES = {}


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def flow_config(config: dict):
    """The program's FlowConfig of the configuration's CLI flags, through
    the CLI's own parser."""
    from meshopticalflow_tpu_torch.apps.optical_flow import build_parser, config_from_args

    argv = ["--in", "a.png", "b.png"]
    for key, val in config["flags"].items():
        if isinstance(val, bool):
            argv += [f"--{key}"] if val else []
        else:
            argv += [f"--{key}", str(val)]
    cfg = config_from_args(build_parser().parse_args(argv))
    march = config["march"]
    if (cfg.flow_min_step, cfg.flow_max_steps) != (march["min_step"], march["max_steps"]):
        raise SpecError(f"the program marches with min step {cfg.flow_min_step} and "
                        f"{cfg.flow_max_steps} steps, the configuration states {march}")
    return cfg


def reference_flags(config: dict) -> dict:
    """The configuration's flags as pbref.flow.ReferenceFlow takes them."""
    flags = dict(config["flags"])
    flags.update(minStep=config["march"]["min_step"], maxSteps=config["march"]["max_steps"])
    flags.setdefault("log", False)
    return flags


class Run:
    """What the loops share: the cell, the device, the system in place, the
    seeded frames, the tracer."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device,
                 workdir: str, log, system: str = "program"):
        import torch

        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.device = torch.device(device)
        self.workdir, self.log = workdir, log
        self.system = SYSTEMS[system]()
        conf = cell.config
        self.cfg = flow_config(conf)
        self.atlas = int(conf["atlas"])
        self.root = cell.path(conf["root_mesh"])
        bases = [read_png(cell.path(p)) for p in conf["base_textures"]]
        self.maker = FrameMaker(bases, self.atlas, conf["frames"], self.device)
        png = cell.traffic.get("png", {})
        self.png = dict(row_filter=png.get("filter", "none"), level=int(png.get("level", 1)))
        self.tracer = Tracer(trace, self.device)
        self.trace_units = int(cell.traffic["trace_units"])
        self.frames = {}      # key -> (path, array, digest)
        self.counters = {}

    def rng(self, stream: int) -> np.random.Generator:
        """A generator of the seed's own, one for each ``stream``."""
        return np.random.default_rng([self.seed & 0xFFFFFFFFFFFFFFFF, stream])

    def frame_files(self, keys):
        """Make and write the frames ``keys`` (each once); their paths."""
        new = [k for k in keys if k not in self.frames]
        arrays = [self.maker.frame(self.seed, k) for k in new]
        paths = [os.path.join(self.workdir, f"frame_{k}.png") for k in new]
        write_pngs(arrays, paths, **self.png)
        seen = {v[2] for v in self.frames.values()}
        for k, a, p in zip(new, arrays, paths):
            d = digest(a)
            if d in seen:
                raise RuntimeError(f"frame {k} repeats an earlier frame")
            seen.add(d)
            self.frames[k] = (p, a, d)
        return [self.frames[k][0] for k in keys]

    def problem(self, keys):
        """The system's problem of the frames ``keys``, its set-up done."""
        prob = self.system.problem(self, self.frame_files(keys))
        sync(self.device)
        return prob

    def reference(self, dtype=None):
        """The plain reference of the configuration (float64, or ``dtype``),
        built once a process."""
        import torch

        from pbref.flow import ReferenceFlow

        key = (self.cell.config_path, self.device, torch.float64)
        if key not in _REFERENCES:
            _REFERENCES[key] = ReferenceFlow(self.root, reference_flags(self.cell.config),
                                             self.atlas, self.atlas, self.device)
        if dtype is None or dtype == torch.float64:
            return _REFERENCES[key]
        cast = key[:2] + (dtype,)
        if cast not in _REFERENCES:
            _REFERENCES[cast] = _REFERENCES[key].as_dtype(dtype)
        return _REFERENCES[cast]

    def begin_trace(self):
        """In a traced run, the profiler and the hooks from here (before the
        window's clock starts) to the end of unit ``trace_units``."""
        if self.tracer.enabled:
            self._hooks = hooks.installed(self.tracer)
            self.counters = self._hooks.__enter__()
            self.tracer.start()

    def traced(self, unit: int):
        if unit == self.trace_units:
            self.end_trace()

    def end_trace(self):
        if self.tracer.active:
            self.tracer.stop()
            self._hooks.__exit__(None, None, None)


class Context:
    """What a metric's reader reads (metrics/<name>.py: read(ctx)): the
    window's units as the loop recorded them, its seconds, the set-up's
    seconds, the device's peak, and in a traced run the trace and the
    counters of its first ``trace_units`` units."""

    def __init__(self, cell, loop, window_s, setup_s, peak_bytes, trace, counters,
                 trace_units):
        self.cell = cell.name
        self.units = loop.units
        self.window_s = window_s
        self.setup_s = setup_s
        self.peak_bytes = peak_bytes
        self.trace = trace
        self.counters = counters
        self.trace_units = trace_units

    def kernel_s(self, *fragments) -> float:
        """Device seconds of the traced part's kernels whose names hold any
        of ``fragments``."""
        return sum(s for name, s in self.trace["kernel_s"].items()
                   if any(f in name for f in fragments))

    def per_pair(self, key: str):
        """Mean over the pairs of the sum over their levels of ``key``."""
        if not self.units or not self.units[0].get("levels"):
            return None
        return float(np.mean([sum(m[key] for m in u["levels"]) for u in self.units]))


def _free(device):
    from meshopticalflow_tpu_torch.utils import devcache

    devcache.clear()
    gc.collect()
    if device.type == "cuda":
        import torch

        torch.cuda.empty_cache()


def _values(metrics, ctx, cell, kind: str) -> dict:
    out = {}
    for m in metrics:
        value = m.reader.read(ctx)
        if value is not None:
            out[m.name] = {"value": float(value), "unit": m.unit}
    if kind == "end_to_end":
        missing = [m.name for m in metrics if m.name not in out]
        if missing:
            raise SpecError(f"cell {cell.name}: the readers of {missing} found nothing "
                            f"to read in its loop's units")
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             t_start=None, log=None, system: str = "program") -> dict:
    """One run; the result line's object. ``system`` "control" puts the
    control in the program's place (pbcore.systems)."""
    t_start = time.time() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    workdir = tempfile.mkdtemp(prefix="portbench-")
    os.environ["MESHFLOW_CACHE"] = os.path.join(workdir, "artifacts")
    try:
        import torch

        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        run = Run(cell, seed, seconds, trace, dev, workdir, log, system)
        loop = cell.loop.Loop(run)
        loop.setup()
        sync(dev)
        t_window = time.time()
        setup_s = t_window - t_start
        n, window_s = loop.window()
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        loop.release()
        _free(dev)
        correct, numbers = check.verdict(loop.check(), cell.config["limits"])
        for line in check.lines(numbers):
            log(line)
        if dev.type == "cuda":
            dev_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                        "count": cell.chips, "memory_peak_bytes": int(peak)}
        else:
            dev_info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
        result = {"correct": bool(correct), "attempted": int(n), "failed": 0}
        tr = run.tracer.result if trace else None
        ctx = Context(cell, loop, window_s, setup_s, peak, tr, run.counters, run.trace_units)
        if trace:
            result["metrics"] = _values(cell.per_layer, ctx, cell, "per_layer")
            dev_info.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
            result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
        else:
            result["metrics"] = _values(cell.end_to_end, ctx, cell, "end_to_end")
        result["device"] = dev_info
        result["check"] = numbers
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
