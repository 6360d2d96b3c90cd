"""Seconds of PNG decode a pair: the program's span ``init.decode`` (both
textures' ``read_png_rgb``, flow/pipeline.py from_texture_inputs) over the
traced pairs, per ``init`` span, from meshopticalflow_tpu_torch.utils.spans
(recorded while the profiler runs). Nothing where the program has no span
record."""


def read(ctx):
    try:
        from meshopticalflow_tpu_torch.utils import spans
    except ImportError:
        return None
    t = spans.totals()["spans"]
    pairs = t.get("init", {}).get("count", 0)
    if not pairs or "init.decode" not in t:
        return None
    return t["init.decode"]["seconds"] / pairs
