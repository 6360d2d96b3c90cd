"""Seconds of the signal preprocessing a pair: the program's span
``init.signals`` (FlowProblem._preprocessed_signals: the DoG band's
multigrid solve, its artifact write and read back, closed by a
synchronize while recording) over the traced pairs, per ``init`` span,
from meshopticalflow_tpu_torch.utils.spans. Nothing where the program has
no span record."""


def read(ctx):
    try:
        from meshopticalflow_tpu_torch.utils import spans
    except ImportError:
        return None
    t = spans.totals()["spans"]
    pairs = t.get("init", {}).get("count", 0)
    if not pairs or "init.signals" not in t:
        return None
    return t["init.signals"]["seconds"] / pairs
