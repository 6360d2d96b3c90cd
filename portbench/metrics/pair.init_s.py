"""Seconds of FlowProblem.from_texture_inputs a pair (PNG decode, bake,
signal preprocessing, device-cache lookups), the benchmark's span around
the call ending in a synchronize; mean over the run's pairs."""


def read(ctx):
    if not ctx.units or "init_s" not in ctx.units[0]:
        return None
    return sum(u["init_s"] for u in ctx.units) / len(ctx.units)
