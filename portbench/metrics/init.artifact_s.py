"""Seconds in the disk artifact cache a pair: the program's spans
``artifact.read`` and ``artifact.write`` (utils/artifacts.py cached: the
npz load, or the savez and rename of a miss) over the traced pairs, per
``init`` span, from meshopticalflow_tpu_torch.utils.spans. Nothing where
the program has no span record."""


def read(ctx):
    try:
        from meshopticalflow_tpu_torch.utils import spans
    except ImportError:
        return None
    t = spans.totals()["spans"]
    pairs = t.get("init", {}).get("count", 0)
    found = [t[n]["seconds"] for n in ("artifact.read", "artifact.write") if n in t]
    if not pairs or not found:
        return None
    return sum(found) / pairs
