"""Signal advection and sampling on top of the tracing kernels.

Port of meshopticalflow_tpu/kernels/advect.py:
  * ResampleSignal (OpticalFlow.cpp:197-216): flow every triangle barycentre
    along the current field, sample the vertex signal there, average into
    vertices;
  * the texel march with lane compaction that the level trace and the
    halfway output use;
  * the bilinear texture fetch (MeshFlow.inl:65-84) with its y-flip and
    clamping semantics.
"""

from __future__ import annotations

import torch

from meshopticalflow_tpu_torch.kernels.tracing import (
    CHECK_EVERY, TraceMesh, _finish, _flow_init, _flow_step, _tables,
    flow_field_trace)


def sample_vertex_signal(triangles: torch.Tensor, values: torch.Tensor,
                         t_idx: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Barycentric interpolation of a per-vertex signal (OpticalFlow.cpp:179-194)."""
    tri = triangles[t_idx]                       # (N, 3)
    w0 = 1.0 - p[:, 0] - p[:, 1]
    return (values[tri[:, 0]] * w0[:, None]
            + values[tri[:, 1]] * p[:, 0:1]
            + values[tri[:, 2]] * p[:, 1:2])


def vertex_mean(triangles: torch.Tensor, per_triangle: torch.Tensor,
                n_vertices: int) -> torch.Tensor:
    """Average per-triangle rows into the triangles' vertices (segment mean)."""
    flat_idx = triangles.reshape(-1)
    contrib = torch.repeat_interleave(per_triangle, 3, dim=0)
    out = torch.zeros((n_vertices,) + tuple(per_triangle.shape[1:]),
                      dtype=per_triangle.dtype, device=per_triangle.device)
    out.index_add_(0, flat_idx, contrib)
    counts = torch.zeros(n_vertices, dtype=per_triangle.dtype,
                         device=per_triangle.device)
    counts.index_add_(0, flat_idx, torch.ones_like(flat_idx, dtype=per_triangle.dtype))
    return out / torch.clamp(counts, min=1.0)[:, None]


def resample_signal(
    tm: TraceMesh,
    vfield: torch.Tensor,         # (T, 2)
    values: torch.Tensor,         # (V, C)
    length,                       # scalar flow time
    min_step: float = 1e-2,
    max_steps: int = 4096,
) -> torch.Tensor:
    """Advect a per-vertex signal by flowing triangle barycentres
    (OpticalFlow.cpp:197-216). Returns (V, C)."""
    t_count = tm.n_triangles
    t0 = torch.arange(t_count, device=values.device)
    p0 = torch.full((t_count, 2), 1.0 / 3.0, dtype=values.dtype, device=values.device)
    t1, p1 = flow_field_trace(tm, vfield, length, t0, p0, min_step, max_steps)
    sampled = sample_vertex_signal(tm.triangles, values, t1, p1)   # (T, C)
    return vertex_mean(tm.triangles, sampled, values.shape[0])


def build_quad_table(texture: torch.Tensor) -> torch.Tensor:
    """(H*W, 12) uint8 table of each texel's bilinear 2x2 footprint —
    [c00 | c10 | c01 | c11] with the sampler's edge clamps baked in
    (x1 = min(x0+1, w-1), y1 = min(y0+1, h-1)). Bilinear sampling then
    gathers one row per lane; the u8 -> compute-dtype cast after the gather
    is exact."""
    h, w = texture.shape[:2]
    t = texture.to(torch.uint8)                        # exact: values are u8
    right = torch.cat([t[:, 1:], t[:, -1:]], dim=1)
    down = torch.cat([t[1:], t[-1:]], dim=0)
    downright = torch.cat([down[:, 1:], down[:, -1:]], dim=1)
    return torch.cat([t, right, down, downright], dim=-1).reshape(h * w, 12)


def sample_texture_bilinear(texture: torch.Tensor, uv: torch.Tensor,
                            bilinear: bool = True,
                            quad: torch.Tensor | None = None) -> torch.Tensor:
    """Texture fetch with the reference's y-flip + clamp (MeshFlow.inl:65-84).

    texture: (H, W, 3) float; uv: (N, 2) in [0,1] uv space (v up).
    ``quad``: optional build_quad_table(texture) — one-row-per-lane
    bilinear gathers with the same values.
    """
    h, w = texture.shape[:2]
    x = torch.clamp(uv[:, 0], 0.0, 1.0) * (w - 1)
    y = torch.clamp(1.0 - uv[:, 1], 0.0, 1.0) * (h - 1)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    if not bilinear:
        return texture.reshape(-1, texture.shape[-1])[y0 * w + x0]
    dx = (x - x0).to(texture.dtype)[:, None]
    dy = (y - y0).to(texture.dtype)[:, None]
    if quad is not None:
        c = texture.shape[-1]
        rows = quad[y0 * w + x0].to(texture.dtype)
        c00, c10, c01, c11 = (rows[:, :c], rows[:, c:2 * c],
                              rows[:, 2 * c:3 * c], rows[:, 3 * c:])
    else:
        flat = texture.reshape(-1, texture.shape[-1])
        x1 = torch.clamp(x0 + 1, max=w - 1)
        y1 = torch.clamp(y0 + 1, max=h - 1)
        c00 = flat[y0 * w + x0]
        c10 = flat[y0 * w + x1]
        c11 = flat[y1 * w + x1]
        c01 = flat[y1 * w + x0]
    return (c00 * (1 - dx) * (1 - dy) + c10 * dx * (1 - dy)
            + c11 * dx * dy + c01 * (1 - dx) * dy)


def flow_field_trace_compacted(tm: TraceMesh, vfield, times, t0, p0, min_step,
                               max_steps: int = 4096, escalate: int = 16,
                               check_every: int = CHECK_EVERY):
    """flow_field_trace with lane compaction and cap escalation (port of
    meshopticalflow_tpu/kernels/advect.py:flow_field_trace_compacted).

    Path lengths are heavy-tailed: between checks, once at most half of the
    marching lanes are live, the live ones are gathered into a smaller batch
    (the finished ones are written back). Lanes still live at ``max_steps``
    keep marching, up to ``escalate * max_steps`` steps in all, emulating the
    reference's effectively unbounded cap (1e6, FEM.inl:905). Per-lane
    results equal an uncompacted march of the same step budget.

    Returns (t1, p1, exhausted_count)."""
    full = _flow_init(vfield, times, t0, p0, min_step)
    tab = _tables(tm, vfield)
    total_budget = max_steps * max(int(escalate), 1)
    idx = None            # lanes of ``full`` that ``sub`` holds (None: all)
    sub = full
    steps_done = 0
    while steps_done < total_budget:
        k = min(check_every, total_budget - steps_done)
        for _ in range(k):
            sub = _flow_step(sub, tab, min_step, 0.0)
        steps_done += k
        live = sub["active"]
        n_live = int(live.sum())
        if n_live == 0:
            break
        if n_live <= live.shape[0] // 2:
            full = _scatter_lanes(full, idx, sub)
            keep = torch.nonzero(live)[:, 0]
            idx = keep if idx is None else idx[keep]
            sub = {key: val[keep] for key, val in sub.items()}
    full = _scatter_lanes(full, idx, sub)
    final_t, final_p = _finish(full, t0, p0)
    return final_t, final_p, int(full["active"].sum())


def _scatter_lanes(full, idx, sub):
    if idx is None:
        return sub
    return {key: full[key].index_copy(0, idx, sub[key]) for key in full}


def _fetch_colors(tri_uvs, texture, t1, p1, bilinear: bool, quad=None):
    """Texture colours at the lanes' end points; 0 for lanes with t < 0."""
    t_safe = torch.clamp(t1, min=0)
    corners = tri_uvs[t_safe]
    w0 = (1.0 - p1[:, 0] - p1[:, 1])[:, None]
    uv = corners[:, 0] * w0 + corners[:, 1] * p1[:, 0:1] + corners[:, 2] * p1[:, 1:2]
    colors = sample_texture_bilinear(texture, uv, bilinear, quad=quad)
    return torch.where((t1 >= 0)[:, None], colors, torch.zeros_like(colors))
