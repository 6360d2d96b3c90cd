"""Seconds from the process's start to the window's: imports, inputs, the
mesh's cold init, the warm-up (host clock)."""


def read(ctx):
    return ctx.setup_s
