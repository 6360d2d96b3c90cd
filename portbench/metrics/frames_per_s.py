"""Halfway frames returned to the host over the window's whole time, its
start to the end of its last frame (host clock)."""


def read(ctx):
    if not ctx.units or "alpha" not in ctx.units[0]:
        return None
    return len(ctx.units) / ctx.window_s
