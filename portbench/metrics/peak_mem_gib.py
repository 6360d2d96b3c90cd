"""torch.cuda.max_memory_allocated() over set-up and window, after
reset_peak_memory_stats() at the run's start, in GiB."""


def read(ctx):
    return ctx.peak_bytes / float(1 << 30)
