"""Share of the traced window in which no kernel or copy ran on the
device, from the profiler's timeline, in percent."""


def read(ctx):
    window = ctx.trace["window_s"]
    if window <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / window)
