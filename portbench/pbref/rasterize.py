"""uv-atlas rasterization: texel -> (triangle, barycentric) sample table
(a frozen copy of the port's numpy geometry/rasterize.py).

Rebuild of the reference GetTextureSource pipeline (Src/MeshFlow.inl:280-467):
  1. scanline-rasterize every uv triangle onto the (W-1, H-1)-scaled lattice,
     first-writer (lowest triangle index) wins;
  2. ``pad_radius`` rounds of nearest-neighbor dilation for seam bleed, with
     the reference's neighbor priority (down, up, right, left);
  3. texels whose barycentric lies outside their triangle are flagged for
     geodesic exp-remap (done on device by kernels.tracing.exp_map).

The (tIdx, barycentric) table this produces is exactly the gather map the
advection kernel consumes. Vectorized numpy, float64.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


def barycentric_coords(v: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Barycentric (s, t) of p w.r.t. triangle corners v (MeshFlow.inl:267-278).

    v: (..., 3, 2), p: (..., 2) -> (..., 2) with p = v0 + s(v1-v0) + t(v2-v0).
    """
    w1 = v[..., 1, :] - v[..., 0, :]
    w2 = v[..., 2, :] - v[..., 0, :]
    det = w1[..., 0] * w2[..., 1] - w1[..., 1] * w2[..., 0]
    det = np.where(det == 0, 1e-300, det)
    d = p - v[..., 0, :]
    s = (d[..., 0] * w2[..., 1] - d[..., 1] * w2[..., 0]) / det
    t = (-d[..., 0] * w1[..., 1] + d[..., 1] * w1[..., 0]) / det
    return np.stack([s, t], axis=-1)


def _sort_by_y(v: np.ndarray) -> np.ndarray:
    """Reference vertex sort by y with its exact tie-breaks (MeshFlow.inl:285-305)."""
    y0, y1, y2 = v[:, 0, 1], v[:, 1, 1], v[:, 2, 1]
    case0 = (y0 <= y1) & (y0 <= y2)
    case1 = ~case0 & (y1 <= y0) & (y1 <= y2)
    maps = np.empty((len(v), 3), np.int64)
    maps[case0] = np.where((y1 <= y2)[case0, None], [0, 1, 2], [0, 2, 1])
    maps[case1] = np.where((y0 <= y2)[case1, None], [1, 0, 2], [1, 2, 0])
    rest = ~case0 & ~case1
    maps[rest] = np.where((y0 <= y1)[rest, None], [2, 0, 1], [2, 1, 0])
    return np.take_along_axis(v, maps[:, :, None], axis=1)


@dataclasses.dataclass
class TextureSource:
    """Per-texel sample table (row-major, index = j*W + i, j in uv space)."""

    tri_idx: np.ndarray      # (H*W,) int32, -1 for unclaimed texels
    bary: np.ndarray         # (H*W, 2) float64
    needs_remap: np.ndarray  # (H*W,) bool: barycentric outside its triangle
    width: int
    height: int


def _repeat_ranges(starts: np.ndarray, counts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Flat (owner_row, value) expansion of ranges [starts, starts+counts)."""
    owners = np.repeat(np.arange(len(counts)), counts)
    offs = np.arange(counts.sum()) - np.repeat(np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
    return owners, starts[owners] + offs


def rasterize_texture_source(face_uvs: np.ndarray, width: int, height: int,
                             pad_radius: int = 2) -> TextureSource:
    """Rasterize all uv triangles and dilate (MeshFlow.inl:410-455).

    face_uvs: (T, 3, 2) wedge uv coordinates in [0, 1]; the port's numpy
    oracle, frozen.
    """
    face_uvs = np.asarray(face_uvs, np.float64)
    t_count = len(face_uvs)
    scale = np.array([width - 1, height - 1], np.float64)
    v = face_uvs * scale  # (T, 3, 2) lattice coordinates
    w = _sort_by_y(v)

    y_start = np.clip(np.ceil(w[:, 0, 1]).astype(np.int64), 0, height - 1)
    y_end = np.clip(np.floor(w[:, 2, 1]).astype(np.int64), 0, height - 1)
    n_rows = np.maximum(0, y_end - y_start + 1)
    tri_of_row, ys = _repeat_ranges(y_start, n_rows)

    # Per (triangle, row): pick upper or lower fan (MeshFlow.inl:310-314).
    wr = w[tri_of_row]
    lower = ys >= wr[:, 1, 1]
    source = np.where(lower[:, None], wr[:, 2, :], wr[:, 0, :])
    slope0 = np.where(lower[:, None], wr[:, 1, :] - wr[:, 2, :], wr[:, 1, :] - wr[:, 0, :])
    slope1 = np.where(lower[:, None], wr[:, 0, :] - wr[:, 2, :], wr[:, 2, :] - wr[:, 0, :])
    ok = (slope0[:, 1] != 0) & (slope1[:, 1] != 0)  # zero-slope rows skipped (inl:315)
    dy = ys - source[:, 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        xi0 = source[:, 0] + dy * slope0[:, 0] / slope0[:, 1]
        xi1 = source[:, 0] + dy * slope1[:, 0] / slope1[:, 1]
    x_lo, x_hi = np.minimum(xi0, xi1), np.maximum(xi0, xi1)
    x_lo, x_hi = np.nan_to_num(x_lo), np.nan_to_num(x_hi)  # masked-out rows only
    x_start = np.clip(np.ceil(x_lo).astype(np.int64), 0, width - 1)
    x_end = np.clip(np.floor(x_hi).astype(np.int64), 0, width - 1)
    ok &= x_end >= x_start
    tri_of_row, ys = tri_of_row[ok], ys[ok]
    x_start, x_end = x_start[ok], x_end[ok]

    row_ids, xs = _repeat_ranges(x_start, x_end - x_start + 1)
    tri_of_px = tri_of_row[row_ids]
    ys_px = ys[row_ids]
    texel = ys_px * width + xs

    # First-writer wins == lowest triangle index per texel (the reference
    # overwrite condition at MeshFlow.inl:334 is vacuous except at exact
    # corner points).
    winner = np.full(width * height, np.iinfo(np.int64).max, np.int64)
    np.minimum.at(winner, texel, tri_of_px)
    keep = winner[texel] == tri_of_px
    # A triangle covers each texel through exactly one scan row, except
    # degenerate double-cover at clamped borders; dedupe keeps the first.
    texel_k, first_idx = np.unique(texel[keep], return_index=True)
    tri_k = tri_of_px[keep][first_idx]
    xs_k, ys_k = xs[keep][first_idx], ys_px[keep][first_idx]

    tri_idx = np.full(width * height, -1, np.int64)
    tri_idx[texel_k] = tri_k
    bary = np.zeros((width * height, 2), np.float64)
    p = np.stack([xs_k, ys_k], axis=1).astype(np.float64)
    bary[texel_k] = barycentric_coords(v[tri_k], p)

    # Dilation rounds (MeshFlow.inl:426-455). Neighbor priority follows the
    # reference scan (last valid wins): down (j+1), up (j-1), right, left.
    tri_img = tri_idx.reshape(height, width)
    for _ in range(pad_radius):
        upd = np.full((height, width), -1, np.int64)

        def shifted(di, dj):
            s = np.full((height, width), -1, np.int64)
            src = tri_img[max(0, -dj): height - max(0, dj), max(0, -di): width - max(0, di)]
            s[max(0, dj): height - max(0, -dj), max(0, di): width - max(0, -di)] = src
            return s

        # shifted(di, dj) places tri[j - dj, i - di] at (j, i); the reference
        # scan's last-valid-wins order gives descending neighbor priority
        # down (j+1) > up (j-1) > right (i+1) > left (i-1)
        # (MeshFlow.inl:378-381), so apply ascending: left, right, up, down.
        for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            cand = shifted(di, dj)
            upd = np.where(cand != -1, cand, upd)
        upd = np.where(tri_img == -1, upd, -1)
        jj, ii = np.nonzero(upd != -1)
        if len(jj) == 0:
            break
        t_new = upd[jj, ii]
        tri_img[jj, ii] = t_new
        p_uv = np.stack([ii / (width - 1), jj / (height - 1)], axis=1)
        bary[jj * width + ii] = barycentric_coords(face_uvs[t_new], p_uv)

    tri_idx = tri_img.ravel()
    inside = (bary[:, 0] >= 0) & (bary[:, 1] >= 0) & (bary.sum(1) <= 1)
    needs_remap = (tri_idx != -1) & ~inside
    return TextureSource(tri_idx.astype(np.int32), bary, needs_remap, width, height)
