"""95th percentile of the frames' latencies, host clock around
halfway_texture (which ends in the copy of the blend to the host), over
the frames of the traced run that the profiler did not cover."""

import numpy as np


def read(ctx):
    untraced = [u["seconds"] for u in ctx.units[ctx.trace_units:] if "alpha" in u]
    if len(untraced) < 20:
        return None
    return 1e3 * float(np.percentile(untraced, 95))
