"""The traced part of a --trace 1 run: torch.profiler over the first units
of the window, reduced to device seconds by kernel name, the device's busy
seconds inside the traced window, the device operations that took most
time, and the idle gaps by what the host was doing (the innermost span of
the harness open when the gap began)."""

from __future__ import annotations

import contextlib
from collections import defaultdict

import torch

WINDOW = "window"


def _ns(event, which: str) -> int:
    fn = getattr(event, which + "_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(event, which + "_us")() * 1000)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Tracer:
    """Spans of the harness (``span``) and, between ``start`` and ``stop``,
    the profiler; idle gaps go to the innermost span open over them."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.device = torch.device(device)
        self.prof = None
        self.active = False
        self.names = set()
        self.result = None

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.active:
            yield
            return
        self.names.add(name)
        with torch.profiler.record_function(name):
            yield

    def start(self) -> None:
        if not self.enabled:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.active = True
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()

    def stop(self) -> None:
        if not self.active:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.active = False
        self.result = self._reduce()
        self.prof = None

    def _reduce(self) -> dict:
        device, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            start = _ns(e, "start")
            end = start + _ns(e, "duration")
            annotation = e.is_user_annotation() or e.name() in self.names \
                or e.name() == WINDOW
            if e.device_type() == torch.autograd.DeviceType.CUDA and not annotation:
                device.append((e.name(), start, end))
            elif annotation and e.device_type() == torch.autograd.DeviceType.CPU:
                host.append((e.name(), start, end))
        windows = [(s, e) for n, s, e in host if n == WINDOW]
        if not windows:
            raise RuntimeError("the profiler recorded no window span")
        w0, w1 = windows[0]
        by_name = defaultdict(float)
        clipped = []
        for name, s, e in device:
            by_name[name] += (e - s) * 1e-9
            s, e = max(s, w0), min(e, w1)
            if e > s:
                clipped.append((s, e))
        busy = _merge(clipped)
        busy_s = sum(e - s for s, e in busy) * 1e-9
        gaps, cursor = [], w0
        for s, e in busy:
            if s > cursor:
                gaps.append((cursor, s))
            cursor = max(cursor, e)
        if w1 > cursor:
            gaps.append((cursor, w1))
        spans = sorted((s, e, n) for n, s, e in host if n != WINDOW)
        idle = defaultdict(float)
        for gs, ge in gaps:
            # split the gap where spans open or close; each piece goes to the
            # innermost (latest-opened) span that covers it, or to "host"
            open_ = [(s, e, n) for s, e, n in spans if s < ge and e > gs]
            cuts = sorted({gs, ge} | {x for s, e, _ in open_ for x in (s, e) if gs < x < ge})
            for a, b in zip(cuts, cuts[1:]):
                owner = "host"
                for s, e, n in open_:
                    if s <= a and e >= b:
                        owner = n
                idle[owner] += (b - a) * 1e-9
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return dict(kernel_s=dict(by_name), busy_s=busy_s, window_s=(w1 - w0) * 1e-9,
                    device_ops=[[n[:64], s] for n, s in top],
                    idle_gaps=[[n, s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:10]])
