"""Share of the memory roofline of the banded sweeps (panel_sweep_kernel):
the bytes the traced part's exact c1 solves need (pbcore.work:
banded_solve_bytes, the panels' non-zero entries and the right-hand sides)
over the device time of the sweep kernels, against 3.35 TB/s."""

from pbcore import work


def read(ctx):
    return work.roofline_pct(ctx.counters.get("banded_bytes", 0),
                             ctx.kernel_s("panel_sweep_kernel"))
