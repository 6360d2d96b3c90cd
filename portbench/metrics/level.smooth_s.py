"""Seconds of the level step's smoothing solve a pair: the sum over the
levels of the program's synced stage clock ``smooth_seconds``; mean over
the run's pairs."""


def read(ctx):
    return ctx.per_pair("smooth_seconds")
