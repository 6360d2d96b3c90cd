"""PNG image I/O (reference: Misha/PNG.inl PNGReadColor/PNGWriteColor).

Reads 8-bit RGB and RGBA PNGs as 8-bit RGB; writes 8-bit RGB. Pure zlib and
numpy: no imaging library is needed on the machine that runs the port.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}   # colour type -> samples per pixel (RGB, RGBA)


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        yield tag, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _unfilter_row(kind: int, row: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """Undo one scanline's filter (PNG spec section 9); uint8 in and out."""
    if kind == 0:
        return row
    if kind == 2:
        return row + prior                       # uint8 wraps mod 256
    if kind == 1:
        px = row.reshape(-1, bpp).astype(np.int64)
        return (np.cumsum(px, axis=0) % 256).astype(np.uint8).ravel()
    if kind not in (3, 4):
        raise ValueError(f"bad PNG filter type {kind}")
    out = bytearray(row.tobytes())
    up = prior.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def read_png_rgb(path: str) -> np.ndarray:
    """Read an 8-bit, non-interlaced RGB or RGBA PNG as (H, W, 3) uint8.

    Alpha is dropped without compositing, as an RGB conversion does."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path} is not a PNG file")
    header, idat = None, []
    for tag, payload in _chunks(data):
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path} has no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: only 8-bit non-interlaced RGB/RGBA PNGs are "
                         f"supported (depth {depth}, colour type {colour}, "
                         f"interlace {interlace})")
    bpp = _CHANNELS[colour]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: image data has {raw.size} bytes, "
                         f"expected {h * (stride + 1)}")
    rows = raw.reshape(h, stride + 1)
    kinds = rows[:, 0]
    pixels = np.empty((h, stride), np.uint8)
    if not kinds.any():
        pixels[:] = rows[:, 1:]
    else:
        prior = np.zeros(stride, np.uint8)
        for y in range(h):
            prior = _unfilter_row(int(kinds[y]), rows[y, 1:], prior, bpp)
            pixels[y] = prior
    return pixels.reshape(h, w, bpp)[:, :, :3].copy()


def write_png_rgb(path: str, pixels: np.ndarray) -> None:
    """Write an (H, W, 3) array as 8-bit RGB PNG; float inputs are clamped
    to [0, 255] and truncated like the reference (OpticalFlow.cpp:112-123)."""
    pixels = np.asarray(pixels)
    if pixels.dtype != np.uint8:
        pixels = np.clip(pixels, 0, 255).astype(np.uint8)
    h, w, _ = pixels.shape
    raw = b"".join(b"\x00" + pixels[y].tobytes() for y in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw)))
        f.write(chunk(b"IEND", b""))
