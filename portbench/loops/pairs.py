"""Distinct texture pairs (frame i, frame i + 1) back to back over one
mesh, one client in a closed loop, as the --serve worker and
TrackSequence run them: from_texture_inputs -> run -> halfway_texture,
the halfway blend kept in memory for the check.

Set-up pays the mesh's cold init on two pairs of frames of their own and
writes frames for twice the pairs that the warm pair's time fits into the
window. A pair never repeats: the program's caches are keyed by content.

Each unit records ``seconds`` (the pair, init to blend), ``init_s`` (the
system's constructor, to a synchronize) and ``levels`` (the program's
per-level stats)."""

from __future__ import annotations

import math
import time

from pbcore import check
from pbcore.session import sync
from pbcore.systems import to_numpy


class Loop:
    def __init__(self, run):
        self.run = run
        self.units = []

    def setup(self):
        r = self.run
        warm = [-1, -2, -3]
        times = []
        for pair in (warm[:2], warm[1:]):
            t0 = time.perf_counter()
            prob = r.problem(pair)
            prob.run()
            prob.halfway_texture()
            del prob
            times.append(time.perf_counter() - t0)
        self.used = {(r.frames[a][2], r.frames[b][2]) for a, b in (warm[:2], warm[1:])}
        pairs = 2 * math.ceil(r.seconds / times[-1]) + 2
        r.log(f"set-up: cold pair {times[0]:.3f} s, warm pair {times[1]:.3f} s; "
              f"{pairs + 1} frames for the window")
        r.frame_files(list(range(pairs + 1)))
        self.n_frames = pairs + 1

    def window(self):
        r = self.run
        r.begin_trace()
        k, t0 = 0, time.perf_counter()
        while k == 0 or time.perf_counter() - t0 < r.seconds:
            if k + 1 >= self.n_frames:
                raise RuntimeError(f"the window ran out of frames after {k} pairs")
            pair = (r.frames[k][2], r.frames[k + 1][2])
            if pair in self.used:
                raise RuntimeError(f"pair {k} repeats an earlier pair")
            self.used.add(pair)
            r.traced(k)
            t_init = time.perf_counter()
            with r.tracer.span("pair.init"):
                prob = r.problem([k, k + 1])
            init_s = time.perf_counter() - t_init
            with r.tracer.span("pair.run"):
                res = prob.run()
            with r.tracer.span("pair.halfway"):
                out = prob.halfway_texture()
            self.units.append(dict(pair=k, init_s=init_s, levels=res.metrics,
                                   tfield=res.tfield, halfway=out,
                                   seconds=time.perf_counter() - t_init))
            del prob, res
            k += 1
        sync(r.device)
        r.end_trace()
        r.log("window: pair seconds " + " ".join(f"{u['seconds']:.3f}" for u in self.units)
              + "; init " + " ".join(f"{u['init_s']:.3f}" for u in self.units))
        return len(self.units), time.perf_counter() - t0

    def release(self):
        pass

    def check(self):
        """One pair drawn from the seed among those finished: its flow and
        its blend against the float64 reference's of the same frames."""
        r = self.run
        j = int(r.rng(7).integers(len(self.units)))
        u = self.units[j]
        tex0, tex1 = r.frames[u["pair"]][1], r.frames[u["pair"] + 1][1]
        t0 = time.perf_counter()
        ref = r.reference()
        t1 = time.perf_counter()
        tf = ref.align(tex0, tex1)
        hw = ref.halfway(tf, tex0, tex1, 0.5)
        r.log(f"check: pair {j} of {len(self.units)}; reference init {t1 - t0:.1f} s, "
              f"alignment and halfway {time.perf_counter() - t1:.1f} s")
        return {"tfield_gap": check.tfield_gap(to_numpy(u["tfield"]), to_numpy(tf)),
                "halfway_mad": check.halfway_mad(u["halfway"], hw)}
