"""Seconds of the level step's flow solve a pair: the sum over the levels
of the program's synced stage clock ``solve_seconds``; mean over the run's
pairs."""


def read(ctx):
    return ctx.per_pair("solve_seconds")
