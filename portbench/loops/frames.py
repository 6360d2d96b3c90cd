"""Halfway frames of one aligned pair: set-up aligns the pair (frames 0
and 1) and warms the first ``warm_frames`` alphas; the window calls
halfway_texture(alpha) back to back, alpha cycling through the mix's
``alphas``, each call returning the uint8 blend to the host.

Each unit records ``alpha`` and ``seconds`` (host clock around the call).
The check compares the set-up pair's flow and ``check_samples`` frames
drawn from the seed among the first ``sample_range``, plus the last."""

from __future__ import annotations

import time

from pbcore import check
from pbcore.systems import to_numpy


class Loop:
    def __init__(self, run):
        self.run = run
        t = run.cell.traffic
        self.alphas = [float(a) for a in t["alphas"]]
        self.warm = int(t["warm_frames"])
        self.sample = set(int(i) for i in run.rng(11).integers(int(t["sample_range"]),
                                                                size=int(t["check_samples"])))
        self.units = []
        self.kept = {}

    def setup(self):
        self.prob = self.run.problem([0, 1])
        self.prob.run()
        for a in self.alphas[:self.warm]:
            self.prob.halfway_texture(a)

    def window(self):
        r, prob = self.run, self.prob
        r.begin_trace()
        i, t0 = 0, time.perf_counter()
        while i == 0 or time.perf_counter() - t0 < r.seconds:
            r.traced(i)
            a = self.alphas[i % len(self.alphas)]
            ts = time.perf_counter()
            with r.tracer.span("frame"):
                out = prob.halfway_texture(a)
            self.units.append(dict(alpha=a, seconds=time.perf_counter() - ts))
            if i in self.sample:
                self.kept[i] = (a, out)
            last = (i, a, out)
            i += 1
        self.kept[last[0]] = last[1:]
        r.end_trace()
        return i, time.perf_counter() - t0

    def release(self):
        self.tfield = to_numpy(self.prob.tfield)
        del self.prob

    def check(self):
        r = self.run
        tex0, tex1 = r.frames[0][1], r.frames[1][1]
        t0 = time.perf_counter()
        ref = r.reference()
        t1 = time.perf_counter()
        tf = ref.align(tex0, tex1)
        out = {"tfield_gap": check.tfield_gap(self.tfield, to_numpy(tf))}
        worst = 0.0
        for i, (a, frame) in sorted(self.kept.items()):
            worst = max(worst, check.halfway_mad(frame, ref.halfway(tf, tex0, tex1, a)))
        r.log(f"check: frames {sorted(self.kept)}; reference init {t1 - t0:.1f} s, "
              f"alignment and halfways {time.perf_counter() - t1:.1f} s")
        out["halfway_mad"] = worst
        return out
