"""Seeded inputs: texture frames made from the 256^2 golden textures,
upsampled to the atlas and warped by a smooth displacement of a fixed size
with a small colour gain, and a PNG codec of their own (8-bit RGB) to
hand them to the program as files: with no row filter, or with libpng's
default choice of a filter for each row.

Every seed gets the same amount of work: the displacement's largest length
and the gain's size are fixed by the configuration, and the seed draws only
the shapes (wave vectors, directions, phases)."""

from __future__ import annotations

import hashlib
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def read_png(path: str) -> np.ndarray:
    """An 8-bit RGB PNG as (H, W, 3) uint8 (filters 0-4)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, header = len(_SIGNATURE), [], None
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + length
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour != 2 or interlace != 0:
        raise ValueError(f"{path}: not an 8-bit non-interlaced RGB PNG")
    stride = 3 * w
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.int32)
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        kind, row = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = row
        elif kind == 2:
            cur = (row + prior) & 255
        else:
            cur = np.zeros(stride, np.int32)
            for i in range(stride):
                a = cur[i - 3] if i >= 3 else 0
                b = prior[i]
                c = prior[i - 3] if i >= 3 else 0
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (row[i] + pred) & 255
        out[y] = cur
        prior = cur
    return out.reshape(h, w, 3).astype(np.uint8)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def adaptive_rows(pixels: np.ndarray, block: int = 256) -> np.ndarray:
    """(H, 3W + 1) filtered scanlines, each row with the filter (0-4) whose
    bytes, read as signed, have the least sum of absolute values: libpng's
    default for 8-bit RGB (and PIL's)."""
    h, w, _ = pixels.shape
    x = pixels.reshape(h, 3 * w).astype(np.int16)
    out = np.empty((h, 3 * w + 1), np.uint8)
    for y0 in range(0, h, block):
        cur = x[y0:y0 + block]
        up = x[y0 - 1:y0 + block - 1] if y0 else np.vstack([np.zeros_like(x[:1]), cur[:-1]])
        left = np.zeros_like(cur)
        left[:, 3:] = cur[:, :-3]
        upleft = np.zeros_like(up)
        upleft[:, 3:] = up[:, :-3]
        cands = np.stack([cur, cur - left, cur - up, cur - ((left + up) >> 1),
                          cur - _paeth(left, up, upleft)]) & 255
        cost = np.minimum(cands, 256 - cands).sum(axis=2)
        kind = np.argmin(cost, axis=0)
        rows = np.arange(cur.shape[0])
        out[y0:y0 + block, 0] = kind
        out[y0:y0 + block, 1:] = cands[kind, rows]
    return out


def png_bytes(pixels: np.ndarray, row_filter: str = "none", level: int = 1) -> bytes:
    """(H, W, 3) uint8 as an RGB PNG: ``row_filter`` "none" (filter 0 on
    every row) or "adaptive" (adaptive_rows), deflate at ``level``."""
    h, w, _ = pixels.shape
    if row_filter == "adaptive":
        raw = adaptive_rows(pixels)
    elif row_filter == "none":
        raw = np.empty((h, 3 * w + 1), np.uint8)
        raw[:, 0] = 0
        raw[:, 1:] = pixels.reshape(h, 3 * w)
    else:
        raise ValueError(f"unknown PNG row filter {row_filter!r}")

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    return (_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + chunk(b"IEND", b""))


def write_pngs(frames, paths, threads: int = 4, row_filter: str = "none",
               level: int = 1) -> None:
    """Encode and write the frames, deflate in ``threads`` threads."""
    def one(item):
        frame, path = item
        with open(path, "wb") as f:
            f.write(png_bytes(frame, row_filter, level))

    with ThreadPoolExecutor(max_workers=threads) as pool:
        list(pool.map(one, zip(frames, paths)))


def digest(frame: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(frame).tobytes()).hexdigest()


class FrameMaker:
    """Frames of one configuration: ``frame(seed, key)`` is the same array
    for the same (seed, key), whatever the order of calls.

    ``params``: ``displacement_texels`` (the largest displacement, in atlas
    texels), ``modes`` (cosine waves summed), ``max_cycles`` (the largest
    wave number across the atlas), ``gain`` (the colour gain's size)."""

    def __init__(self, bases, atlas: int, params: dict, device):
        self.device = torch.device(device)
        # float64 throughout: a rounding to uint8 that lands on a half
        # would otherwise follow the code path (vector or scalar) a CPU
        # thread split gives each texel
        self.bases = [torch.as_tensor(b).to(self.device, torch.float64)
                      .permute(2, 0, 1)[None].contiguous() for b in bases]
        self.atlas = int(atlas)
        self.params = params
        a = self.atlas
        coords = (torch.arange(a, device=self.device, dtype=torch.float64) + 0.5) / a
        self.gy, self.gx = torch.meshgrid(coords, coords, indexing="ij")

    def _draws(self, seed: int, key: int):
        ss = np.random.SeedSequence([int(seed) & 0xFFFFFFFFFFFFFFFF, int(key) & 0xFFFFFFFF])
        rng = np.random.default_rng(ss)
        m, top = int(self.params["modes"]), int(self.params["max_cycles"])
        waves = rng.integers(-top, top + 1, size=(m, 2))
        waves[np.all(waves == 0, axis=1)] = (1, 0)
        angles = rng.uniform(0, 2 * np.pi, size=m)
        phases = rng.uniform(0, 2 * np.pi, size=m)
        gain_phases = rng.uniform(0, 2 * np.pi, size=3)
        return waves, angles, phases, gain_phases

    def frame(self, seed: int, key: int) -> np.ndarray:
        """(atlas, atlas, 3) uint8 frame ``key`` of the seed's sequence; key
        parity picks the base texture."""
        waves, angles, phases, gain_phases = self._draws(seed, key)
        dx = torch.zeros_like(self.gx)
        dy = torch.zeros_like(self.gx)
        for (kx, ky), ang, ph in zip(waves, angles, phases):
            wave = torch.cos(2 * np.pi * (float(kx) * self.gx + float(ky) * self.gy) + float(ph))
            dx = dx + float(np.cos(ang)) * wave
            dy = dy + float(np.sin(ang)) * wave
        size = torch.sqrt(dx * dx + dy * dy).max()
        scale = float(self.params["displacement_texels"]) / self.atlas / size
        # grid_sample's coordinates run from -1 to 1 across the texture
        grid = torch.stack([(self.gx + dx * scale) * 2 - 1, (self.gy + dy * scale) * 2 - 1],
                           dim=-1)[None]
        base = self.bases[key % len(self.bases)]
        warped = torch.nn.functional.grid_sample(base, grid, mode="bilinear",
                                                 padding_mode="border", align_corners=False)
        gain = 1.0 + float(self.params["gain"]) * torch.cos(
            torch.as_tensor(gain_phases, dtype=torch.float64, device=self.device))
        out = torch.clamp(warped[0] * gain[:, None, None] + 0.5, 0, 255).to(torch.uint8)
        return out.permute(1, 2, 0).contiguous().cpu().numpy()
