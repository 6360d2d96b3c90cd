"""Flow-solve iterations a pair: the sum over the levels of the program's
``flow_iters`` count; mean over the run's pairs."""


def read(ctx):
    return ctx.per_pair("flow_iters")
