"""Seconds of the banded c1 factorizations a pair: the program's span
``mg.c1_factor`` (solvers/mg.py, one a multigrid solver built: the DoG
solve's and two a level; closed by a synchronize while recording) over the
traced pairs, per ``init`` span, from meshopticalflow_tpu_torch.utils.spans.
Nothing where the program has no span record."""


def read(ctx):
    try:
        from meshopticalflow_tpu_torch.utils import spans
    except ImportError:
        return None
    t = spans.totals()["spans"]
    pairs = t.get("init", {}).get("count", 0)
    if not pairs or "mg.c1_factor" not in t:
        return None
    return t["mg.c1_factor"]["seconds"] / pairs
