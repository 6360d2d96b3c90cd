"""Spans and counters of the port: one record on the profiler's clock.

A span names a stretch of the program's work: ``with span("init.decode"):``.
While the record is on, a span opens a ``torch.profiler.record_function`` of
its name and records the name, its start and end on ``time.time_ns()`` (the
clock the profiler stamps its host events with), the span it opened inside
and the job it belongs to (``job``: one id a ``FlowProblem``, shared by its
init, run and halfway spans). ``device=True`` also records a pair of CUDA
events on the current stream; they are resolved when the record is read, so
a span never makes the host wait for the device.

The record is on while a torch profiler runs, and in a process started with
``MESHFLOW_SPANS=<path>``, which writes the record there as JSON lines at
exit (one line a span, then one line of the counters). Off, ``span`` is one
check and a shared no-op context: no clock read, allocation, profiler call or
synchronize.

``timed`` is a span whose host seconds are read whether the record is on or
not, for the clocks the program reports in every run: ``init_profile``, the
level step's stage seconds, the solvers' ``factor_seconds``. Before it
closes it synchronizes ``sync`` (a CUDA device) while the record is on, or
in every run with ``always_sync``.

Counters (``count``) always count, one integer add: the kernel modules'
launches (``launch.<kernel>[/<form>]``), the halfway blend's bytes and
lanes. ``totals`` sums the record by span name, ``reset`` clears it. At
most ``MAX_SPANS`` closed spans are kept; older ones are dropped and counted
under ``spans.dropped``.
"""

from __future__ import annotations

import atexit
import functools
import itertools
import json
import os
import threading
import time
from collections import Counter, deque
from typing import Optional

import torch

MAX_SPANS = 200_000

_PATH: Optional[str] = os.environ.get("MESHFLOW_SPANS") or None
_profiling = torch._C._autograd._profiler_enabled

# closed spans, oldest first: [name, start_ns, end_ns, id, parent id, job,
# start event, end event]; the events become device seconds once read
_spans: deque = deque(maxlen=MAX_SPANS)
_counts: Counter = Counter()
_local = threading.local()     # .stack: open spans; .job: the current job id
_span_ids = itertools.count(1)
_job_ids = itertools.count(1)


def recording() -> bool:
    """Whether spans are recorded: a profiler runs, or ``MESHFLOW_SPANS``."""
    return _PATH is not None or _profiling()


class _Off:
    """The shared no-op span of an unrecorded ``span`` or ``job``."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    """One span; ``seconds`` holds its host seconds once closed."""

    __slots__ = ("name", "record", "events", "sync", "always_sync", "seconds", "_rf",
                 "_start", "_id", "_parent", "_job", "_ev")

    def __init__(self, name: str, record: bool, events: bool = False, sync=None,
                 always_sync: bool = False):
        self.name, self.record = name, record
        self.events = events and record and torch.cuda.is_initialized()
        self.sync = sync if sync is not None and torch.device(sync).type == "cuda" else None
        self.always_sync = always_sync
        self.seconds = 0.0

    def __enter__(self):
        if self.record:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
            stack = _stack()
            self._parent = stack[-1]._id if stack else None
            self._id = next(_span_ids)
            self._job = getattr(_local, "job", None)
            stack.append(self)
            if self.events:
                self._ev = torch.cuda.Event(enable_timing=True)
                self._ev.record()
        self._start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ev = None
        if self.events:
            end_ev = torch.cuda.Event(enable_timing=True)
            end_ev.record()
        if self.sync is not None and (self.record or self.always_sync):
            torch.cuda.synchronize(self.sync)
        end = time.time_ns()
        self.seconds = (end - self._start) * 1e-9
        if self.record:
            _stack().pop()
            self._rf.__exit__(None, None, None)
            if len(_spans) == MAX_SPANS:
                _counts["spans.dropped"] += 1
            _spans.append([self.name, self._start, end, self._id, self._parent, self._job,
                           self._ev if self.events else None, end_ev])
        return False


def span(name: str, device: bool = False):
    """A span of ``name``; ``device`` also times it with CUDA events (where
    CUDA is initialized)."""
    if _PATH is None and not _profiling():
        return _OFF
    return _Span(name, True, events=device)


def timed(name: str, sync=None, always_sync: bool = False) -> _Span:
    """A span of ``name`` whose ``seconds`` are read in every run; it
    synchronizes the CUDA device ``sync`` before it closes while the record
    is on, or always with ``always_sync``."""
    return _Span(name, recording(), sync=sync, always_sync=always_sync)


def new_job() -> int:
    """A fresh job id."""
    return next(_job_ids)


class _Job:
    __slots__ = ("job", "_saved")

    def __init__(self, job_id: int):
        self.job = job_id

    def __enter__(self):
        self._saved = getattr(_local, "job", None)
        _local.job = self.job
        return self

    def __exit__(self, *exc):
        _local.job = self._saved
        return False


def job(job_id: int):
    """The spans opened in the block belong to job ``job_id``."""
    if _PATH is None and not _profiling():
        return _OFF
    return _Job(job_id)


# -- counters -----------------------------------------------------------------

def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counts[name] += n


def counter(name: str) -> int:
    """The counter ``name`` (0 if never counted)."""
    return _counts[name]


def _under(name: str, prefix: str) -> bool:
    return name == prefix or name.startswith(prefix + "/")


def counted(prefix: str) -> int:
    """The sum of the counter ``prefix`` and of its forms ``prefix/...``."""
    return sum(v for k, v in _counts.items() if _under(k, prefix))


def forms(namespace: str, *names: str) -> dict:
    """The counters ``<namespace>.<name>/<form>`` of each of ``names``,
    keyed ``<name>/<form>`` in sorted order."""
    cut = len(namespace) + 1
    return {k[cut:]: v for k, v in sorted(_counts.items())
            if any(k.startswith(f"{namespace}.{n}/") for n in names)}


def clear(*prefixes: str) -> None:
    """Drop the counters under each of ``prefixes`` (the name and its forms)."""
    for k in [k for k in _counts if any(_under(k, p) for p in prefixes)]:
        del _counts[k]


class _Launched:
    """A kernel wrapper whose ``launches`` are read from the counter table:
    the sum of ``key`` and its forms."""

    def __init__(self, key: str, fn):
        functools.update_wrapper(self, fn)
        self.key = key

    def __call__(self, *args, **kwargs):
        return self.__wrapped__(*args, **kwargs)

    @property
    def launches(self) -> int:
        return counted(self.key)


def launches(key: str):
    """Decorate a kernel wrapper so that ``wrapper.launches`` reads the
    counter ``key`` (and its forms) that its launches count into."""
    return functools.partial(_Launched, key)


# -- the record -----------------------------------------------------------------

def _device_seconds(rec) -> Optional[float]:
    ev = rec[6]
    if ev is None:
        return None
    if isinstance(ev, torch.cuda.Event):
        rec[7].synchronize()
        rec[6], rec[7] = ev.elapsed_time(rec[7]) * 1e-3, None
    return rec[6]


def records() -> list:
    """The recorded spans, oldest first, as dicts (``device_s`` where the
    span was timed on the device)."""
    out = []
    for rec in list(_spans):
        d = dict(name=rec[0], start_ns=rec[1], end_ns=rec[2], id=rec[3], parent=rec[4],
                 job=rec[5])
        dev = _device_seconds(rec)
        if dev is not None:
            d["device_s"] = dev
        out.append(d)
    return out


def totals() -> dict:
    """``{"spans": {name: {count, seconds, self_seconds[, device_seconds]}},
    "counters": {...}}``: per span name its count, host seconds, self
    seconds (its duration less what its child spans cover) and, where it
    was timed on the device, device seconds."""
    recs = list(_spans)
    covered = Counter()
    for rec in recs:
        if rec[4] is not None:
            covered[rec[4]] += rec[2] - rec[1]
    out = {}
    for rec in recs:
        t = out.setdefault(rec[0], dict(count=0, seconds=0.0, self_seconds=0.0))
        ns = rec[2] - rec[1]
        t["count"] += 1
        t["seconds"] += ns * 1e-9
        t["self_seconds"] += (ns - covered[rec[3]]) * 1e-9
        dev = _device_seconds(rec)
        if dev is not None:
            t["device_seconds"] = t.get("device_seconds", 0.0) + dev
    return dict(spans=out, counters=dict(_counts))


def reset() -> None:
    """Clear the record: spans and counters."""
    _spans.clear()
    _counts.clear()


def write(path: str) -> None:
    """The record as JSON lines: one a span, then ``{"counters": ...}``."""
    with open(path, "w") as f:
        for d in records():
            f.write(json.dumps(d) + "\n")
        f.write(json.dumps(dict(counters=dict(_counts))) + "\n")


if _PATH is not None:
    atexit.register(lambda: write(_PATH))
