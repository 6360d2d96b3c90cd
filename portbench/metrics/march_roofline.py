"""Share of the memory roofline of the march kernels (march_kernel): the
bytes the traced part's marches need (pbcore.work: march_bytes, each
lane's start and end once and the mesh tables once a march) over the
device time of the march kernels, against 3.35 TB/s."""

from pbcore import work


def read(ctx):
    return work.roofline_pct(ctx.counters.get("march_bytes", 0), ctx.kernel_s("march_kernel"))
