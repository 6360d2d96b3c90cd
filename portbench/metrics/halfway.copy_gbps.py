"""Rate of the blend's copy to the host, GB/s: the bytes of the traced
frames' blends over the device seconds (CUDA events) of the program's span
``halfway.copy`` (flow/pipeline.py halfway_texture, the uint8 blend to a
pageable numpy array), from meshopticalflow_tpu_torch.utils.spans. The
counters ``halfway.copy_bytes`` and ``halfway.copies`` count every call of
the process, so a copy's bytes are their quotient (every frame of a cell
has one size). Nothing where the span carries no device time (the CPU) or
the program has no span record."""


def read(ctx):
    try:
        from meshopticalflow_tpu_torch.utils import spans
    except ImportError:
        return None
    tot = spans.totals()
    copy = tot["spans"].get("halfway.copy", {})
    copies = tot["counters"].get("halfway.copies", 0)
    if not copy.get("device_seconds") or not copies:
        return None
    per_copy = tot["counters"]["halfway.copy_bytes"] / copies
    return per_copy * copy["count"] / copy["device_seconds"] / 1e9
