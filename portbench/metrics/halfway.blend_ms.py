"""Device milliseconds of the fetch and blend a frame: the CUDA events of
the program's spans ``halfway.fetch`` (both textures' _fetch_colors,
kernels/advect.py) and ``halfway.tail`` (_halfway_tail: scatter to raster
order, fill, blend, quantize) over the traced frames, per ``halfway`` span,
from meshopticalflow_tpu_torch.utils.spans. Nothing where the spans carry
no device time (the CPU) or the program has no span record."""


def read(ctx):
    try:
        from meshopticalflow_tpu_torch.utils import spans
    except ImportError:
        return None
    t = spans.totals()["spans"]
    frames = t.get("halfway", {}).get("count", 0)
    device_s = [t.get(n, {}).get("device_seconds") for n in ("halfway.fetch", "halfway.tail")]
    if not frames or None in device_s:
        return None
    return 1e3 * sum(device_s) / frames
