"""Share of the memory roofline of the ELL products (spmv_slab_kernel,
spmv_group_kernel): the bytes the traced part's launches need
(pbcore.work: spmv_bytes, stored non-zeros, x and y of each launch) over
the device time of the SpMV kernels, against 3.35 TB/s."""

from pbcore import work


def read(ctx):
    return work.roofline_pct(ctx.counters.get("spmv_bytes", 0),
                             ctx.kernel_s("spmv_slab_kernel", "spmv_group_kernel"))
