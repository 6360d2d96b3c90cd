"""Pairs finished over the window's whole time, its start to the end of
its last pair (host clock)."""


def read(ctx):
    if not ctx.units or "init_s" not in ctx.units[0]:
        return None
    return len(ctx.units) / ctx.window_s
