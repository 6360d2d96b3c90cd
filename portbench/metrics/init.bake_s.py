"""Seconds of the bake a pair: the program's span ``init.bake`` (the two
textures' content hashes and ``sample_texture_to_vertices`` through the
artifact cache, flow/pipeline.py from_texture_inputs) over the traced
pairs, per ``init`` span, from meshopticalflow_tpu_torch.utils.spans.
Nothing where the program has no span record."""


def read(ctx):
    try:
        from meshopticalflow_tpu_torch.utils import spans
    except ImportError:
        return None
    t = spans.totals()["spans"]
    pairs = t.get("init", {}).get("count", 0)
    if not pairs or "init.bake" not in t:
        return None
    return t["init.bake"]["seconds"] / pairs
