"""Device seconds of the exact c1 solves a pair: the CUDA events of the
program's span ``mg.c1_solve`` (solvers/mg.py _inner1_exact: the permuted
right-hand side, the two panel sweeps, the scatter back; one a V-cycle)
over the traced pairs, per ``init`` span, from
meshopticalflow_tpu_torch.utils.spans. Nothing where the spans carry no
device time (the CPU) or the program has no span record."""


def read(ctx):
    try:
        from meshopticalflow_tpu_torch.utils import spans
    except ImportError:
        return None
    t = spans.totals()["spans"]
    pairs = t.get("init", {}).get("count", 0)
    device_s = t.get("mg.c1_solve", {}).get("device_seconds")
    if not pairs or device_s is None:
        return None
    return device_s / pairs
