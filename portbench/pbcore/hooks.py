"""Instrumentation of the traced part of a run, from the benchmark's side:
spans around the level step's stages (smoothing, trace and data term, flow
solve), and the work of each SpMV launch, exact c1 solve and march, counted
from its operands (pbcore.work). Installed only while the profiler runs."""

from __future__ import annotations

import contextlib
from collections import Counter

from pbcore import work


@contextlib.contextmanager
def installed(tracer):
    """Patch the port's module attributes for the block; returns the
    counters ("spmv_bytes", "banded_bytes", "march_bytes") it fills."""
    from meshopticalflow_tpu_torch.flow import pipeline
    from meshopticalflow_tpu_torch.kernels import advect, spmv, tracing
    from meshopticalflow_tpu_torch.solvers import mg

    counters = Counter()
    nonzeros = work.NonzeroCache()
    saved = []

    def patch(module, name, make):
        real = getattr(module, name)
        saved.append((module, name, real))
        setattr(module, name, make(real))

    def spanned(span):
        def make(real):
            def call(*args, **kwargs):
                with tracer.span(span):
                    return real(*args, **kwargs)
            return call
        return make

    patch(pipeline, "_stage_smooth", spanned("level.smooth"))
    patch(pipeline, "_stage_resample", spanned("level.trace"))
    patch(pipeline, "update_optical_flow", spanned("level.solve"))

    def spmv_launch(real):
        def call(name, cols, vals, x, y, c):
            counters["spmv_bytes"] += work.spmv_bytes(
                nonzeros.count(vals), vals.element_size(), x.shape[0], cols.shape[0], c,
                x.element_size())
            return real(name, cols, vals, x, y, c)
        return call

    def c1_solve(real):
        def call(dinv, pbelow, band, r1):
            counters["banded_bytes"] += work.banded_solve_bytes(
                nonzeros.count(dinv, pbelow), dinv.element_size(), r1.numel(),
                r1.element_size())
            return real(dinv, pbelow, band, r1)
        return call

    def march(real):
        def call(tm, flow_time, t_idx, p, *args, **kwargs):
            counters["march_bytes"] += work.march_bytes(p.shape[0], tm.n_triangles,
                                                        p.element_size())
            return real(tm, flow_time, t_idx, p, *args, **kwargs)
        return call

    patch(spmv, "_launch", spmv_launch)
    patch(mg, "_inner1_exact", c1_solve)
    patch(tracing, "march", march)
    patch(advect, "march", lambda real: tracing.march)
    try:
        yield counters
    finally:
        for module, name, real in reversed(saved):
            setattr(module, name, real)
