"""Geodesic marches and samplers in plain PyTorch: frozen copies of the
port's plain versions (kernels/tracing.py ``*_plain``, kernels/advect.py),
the batched masked iteration of FEM::RiemannianMesh::flow (FEM.inl:901-994)
and ::exp (FEM.inl:834-899) over every lane at once, and the texture and
vertex samplers (MeshFlow.inl:65-84, OpticalFlow.cpp:179-216)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from pbref.mesh import HostMesh

CHECK_EVERY = 32


@dataclasses.dataclass
class TraceMesh:
    """Device-resident mesh tables for tracing and sampling."""

    triangles: torch.Tensor     # (T, 3) int64
    g: torch.Tensor             # (T, 2, 2)
    g_inv: torch.Tensor         # (T, 2, 2)
    area: torch.Tensor          # (T,)
    opp: torch.Tensor           # (3T,) int64
    xform_linear: torch.Tensor  # (3T, 2, 2)
    xform_const: torch.Tensor   # (3T, 2)

    @property
    def n_triangles(self) -> int:
        return self.triangles.shape[0]


def make_trace_mesh(mesh: HostMesh, dtype, device) -> TraceMesh:
    def dev(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    return TraceMesh(triangles=dev(mesh.triangles, torch.int64), g=dev(mesh.g, dtype),
                     g_inv=dev(mesh.g_inv, dtype), area=dev(mesh.area, dtype),
                     opp=dev(mesh.opp, torch.int64),
                     xform_linear=dev(mesh.xform_linear, dtype),
                     xform_const=dev(mesh.xform_const, dtype))


@dataclasses.dataclass
class _Tables:
    """Flat per-triangle and per-half-edge tables one march step reads, and
    the per-triangle field (``field``) the march follows."""

    g3: torch.Tensor      # (T, 3): g00, g01, g11
    opp: torch.Tensor     # (3T,)
    lin: torch.Tensor     # (3T, 4) row-major 2x2
    const: torch.Tensor   # (3T, 2)
    field: Optional[torch.Tensor] = None    # (T, 2)

    def field_at(self, t, px, py):
        """The field at chart point (px, py) of triangle t: the triangle's
        vector. Returns (vx, vy)."""
        vf = self.field[t]
        return vf[:, 0], vf[:, 1]


def _tables(tm: TraceMesh, vfield: Optional[torch.Tensor] = None) -> _Tables:
    g3 = torch.stack([tm.g[:, 0, 0], tm.g[:, 0, 1], tm.g[:, 1, 1]], -1)
    tab = _Tables(g3, tm.opp, tm.xform_linear.reshape(-1, 4), tm.xform_const.reshape(-1, 2))
    if vfield is not None:
        tab.field = vfield.to(tm.g.dtype)
    return tab


def _edge_exit(px, py, vx, vy, in_edge, eps):
    """Largest positive ray-edge intersection (FEM.inl:916-927).

    Candidates in the reference order (bottom -> chart edge 2, left -> 1,
    diagonal -> 0), keeping the larger s. Returns (s, idx), idx = -1 when no
    edge is hit. Zero denominators are masked explicitly, so every surviving
    quantity is finite."""
    cands = (
        (-py, vy, px, vx, 2),                        # bottom edge
        (-px, vx, py, vy, 1),                        # left edge
        (1.0 - px - py, vx + vy, px, vx, 0),         # diagonal
    )
    best_s = torch.zeros_like(px)
    best_idx = torch.full_like(in_edge, -1)
    for num, den, fp, fv, idx in cands:
        nonzero = den != 0
        s_cand = num / torch.where(nonzero, den, torch.ones_like(den))
        foo = fp + fv * s_cand
        ok = (nonzero & (in_edge != idx) & (s_cand > 0)
              & (foo >= -eps) & (foo <= 1 + eps) & (s_cand > best_s))
        best_s = torch.where(ok, s_cand, best_s)
        best_idx = torch.where(ok, idx, best_idx)
    return best_s, best_idx


def _metric_dot(g3, ax, ay, bx, by):
    """a^T g b with g = [[g00, g01], [g01, g11]]."""
    return ((ax * g3[:, 0] + ay * g3[:, 1]) * bx
            + (ax * g3[:, 1] + ay * g3[:, 2]) * by)


def _transform(lin, const, px, py):
    """lin @ (px, py) + const, lin given row-major (N, 4)."""
    qx = lin[:, 0] * px + lin[:, 1] * py
    qy = lin[:, 2] * px + lin[:, 3] * py
    if const is not None:
        qx = qx + const[:, 0]
        qy = qy + const[:, 1]
    return qx, qy


def _flow_init(tab: _Tables, flow_time, t_idx, p, min_step) -> Dict[str, torch.Tensor]:
    dtype, device = p.dtype, p.device
    n = p.shape[0]
    flow_time = torch.as_tensor(flow_time, dtype=dtype, device=device).expand(n)
    direction = torch.where(flow_time < 0, -1.0, 1.0).to(dtype)
    t_safe = torch.clamp(t_idx.to(torch.int64), min=0)
    vx, vy = tab.field_at(t_safe, p[:, 0], p[:, 1])
    vx, vy = vx * direction, vy * direction
    return dict(
        t=t_safe,
        px=p[:, 0].clone(), py=p[:, 1].clone(),
        vx=vx, vy=vy,
        ft=torch.abs(flow_time).clone(),
        step_left=torch.full((n,), min_step, dtype=dtype, device=device),
        in_edge=torch.full((n,), -1, dtype=torch.int64, device=device),
        direction=direction,
        active=(t_idx >= 0) & (vx * vx + vy * vy > 0),
    )


def _flow_step(s, tab: _Tables, min_step: float, eps: float):
    """One march step of FEM::RiemannianMesh::flow (FEM.inl:901-994)."""
    t, ft, px, py, vx, vy = s["t"], s["ft"], s["px"], s["py"], s["vx"], s["vy"]
    direction = s["direction"]
    active = s["active"] & (vx * vx + vy * vy > 0)
    step, idx = _edge_exit(px, py, vx, vy, s["in_edge"], eps)
    active = active & (idx >= 0)

    e = t * 3 + torch.clamp(idx, min=0)
    g3 = tab.g3[t]
    vgv = _metric_dot(g3, vx, vy, vx, vy)
    sq_step = vgv * step * step
    if min_step > 0:
        update_vector = sq_step > s["step_left"] * s["step_left"]
    else:
        update_vector = torch.zeros_like(active)
    safe_vgv = torch.where(vgv > 0, vgv, torch.ones_like(vgv))
    step = torch.where(update_vector, s["step_left"] / torch.sqrt(safe_vgv), step)

    finish = ft < step
    # Common advance: by ft when finishing, else by step.
    adv = torch.where(finish, ft, step)
    npx = px + vx * adv
    npy = py + vy * adv
    new_ft = ft - adv

    # Re-sample branch (no edge crossing): stop on direction reversal
    # (FEM.inl:957-968), else reset to the local field value.
    vfx, vfy = tab.field_at(t, npx, npy)
    reversal = _metric_dot(g3, vx, vy, vfx, vfy) * direction < 0
    resample = active & ~finish & update_vector
    nvx = torch.where(resample, vfx * direction, vx)
    nvy = torch.where(resample, vfy * direction, vy)
    new_step_left = torch.where(resample, min_step, s["step_left"])
    new_in_edge = torch.where(resample, -1, s["in_edge"])

    # Crossing branch (FEM.inl:970-989).
    cross = active & ~finish & ~update_vector
    opp_e = tab.opp[e]
    hit_boundary = cross & (opp_e < 0)
    lin = tab.lin[e]
    cpx, cpy = _transform(lin, tab.const[e], npx, npy)
    cvx, cvy = _transform(lin, None, nvx, nvy)
    do_cross = cross & (opp_e >= 0)
    new_t = torch.where(do_cross, torch.div(opp_e, 3, rounding_mode="floor"), t)
    npx = torch.where(do_cross, cpx, npx)
    npy = torch.where(do_cross, cpy, npy)
    nvx = torch.where(do_cross, cvx, nvx)
    nvy = torch.where(do_cross, cvy, nvy)
    new_in_edge = torch.where(do_cross, torch.remainder(opp_e, 3), new_in_edge)
    new_step_left = torch.where(
        do_cross, new_step_left - torch.sqrt(torch.clamp(sq_step, min=0)),
        new_step_left)

    still_active = active & ~finish & ~hit_boundary & ~(resample & reversal)
    # Inactive lanes keep their previous state frozen.
    keep = s["active"]
    out = dict(
        t=torch.where(keep, new_t, t),
        px=torch.where(keep, npx, px),
        py=torch.where(keep, npy, py),
        vx=torch.where(keep, nvx, vx),
        vy=torch.where(keep, nvy, vy),
        ft=torch.where(keep, new_ft, ft),
        step_left=torch.where(keep, new_step_left, s["step_left"]),
        in_edge=torch.where(keep, new_in_edge, s["in_edge"]),
        direction=direction,
        active=still_active,
    )
    return out


def _run_steps(step_fn, state, steps: int, check_every: int = CHECK_EVERY):
    """Apply ``step_fn`` up to ``steps`` times, stopping early once no lane
    is live (tested every ``check_every`` steps). Returns (state, done)."""
    done = 0
    while done < steps:
        k = min(check_every, steps - done)
        for _ in range(k):
            state = step_fn(state)
        done += k
        if not bool(state["active"].any()):
            break
    return state, done


def _finish(state, t_idx, p):
    valid = t_idx >= 0
    final_t = torch.where(valid, state["t"], t_idx.to(torch.int64))
    out_p = torch.stack([state["px"], state["py"]], -1)
    final_p = torch.where(valid[:, None], out_p, p)
    return final_t, final_p


def exp_map_plain(
    tm: TraceMesh,
    t_idx: torch.Tensor,   # (N,)
    p: torch.Tensor,       # (N, 2)
    v: torch.Tensor,       # (N, 2) displacement in the starting chart
    max_steps: int = 1024,
    eps: float = 0.0,
    with_diagnostics: bool = False,
):
    """Batched FEM::RiemannianMesh::exp (FEM.inl:834-899): straight-line
    geodesic carrying the remaining displacement across charts.
    ``with_diagnostics`` appends the cap-exhausted lane count."""
    n = p.shape[0]
    valid = t_idx >= 0
    t = torch.clamp(t_idx.to(torch.int64), min=0)
    in_edge = torch.full((n,), -1, dtype=torch.int64, device=p.device)
    active = valid & ((v * v).sum(-1) > 0)
    px, py, vx, vy = p[:, 0], p[:, 1], v[:, 0], v[:, 1]
    tab = _tables(tm)

    # Starting-point-on-edge pre-step (FEM.inl:843-858).
    idx = torch.full((n,), -1, dtype=torch.int64, device=p.device)
    idx = torch.where((px <= 0) & (vx < 0), 1, idx)
    idx = torch.where((idx == -1) & (py <= 0) & (vy < 0), 2, idx)
    idx = torch.where((idx == -1) & (px + py >= 1) & (vx + vy > 0), 0, idx)
    pre = active & (idx != -1)
    e = t * 3 + torch.clamp(idx, min=0)
    opp_e = tab.opp[e]
    pre = pre & (opp_e >= 0)
    lin = tab.lin[e]
    cpx, cpy = _transform(lin, tab.const[e], px, py)
    cvx, cvy = _transform(lin, None, vx, vy)
    state = dict(
        t=torch.where(pre, torch.div(opp_e, 3, rounding_mode="floor"), t),
        px=torch.where(pre, cpx, px), py=torch.where(pre, cpy, py),
        vx=torch.where(pre, cvx, vx), vy=torch.where(pre, cvy, vy),
        in_edge=torch.where(pre, torch.remainder(opp_e, 3), in_edge),
        active=active)

    def step(s):
        t, px, py, vx, vy = s["t"], s["px"], s["py"], s["vx"], s["vy"]
        active = s["active"]
        step_s, idx = _edge_exit(px, py, vx, vy, s["in_edge"], eps)
        active = active & (idx >= 0)
        finish = step_s > 1  # endpoint inside the triangle (FEM.inl:881-885)
        npx = torch.where(finish, px + vx, px + vx * step_s)
        npy = torch.where(finish, py + vy, py + vy * step_s)
        nvx = torch.where(finish, torch.zeros_like(vx), vx * (1 - step_s))
        nvy = torch.where(finish, torch.zeros_like(vy), vy * (1 - step_s))
        e = t * 3 + torch.clamp(idx, min=0)
        opp_e = tab.opp[e]
        cross = active & ~finish & (opp_e >= 0)
        lin = tab.lin[e]
        cpx, cpy = _transform(lin, tab.const[e], npx, npy)
        cvx, cvy = _transform(lin, None, nvx, nvy)
        keep = s["active"]
        return dict(
            t=torch.where(keep & cross, torch.div(opp_e, 3, rounding_mode="floor"), t),
            px=torch.where(keep, torch.where(cross, cpx, npx), px),
            py=torch.where(keep, torch.where(cross, cpy, npy), py),
            vx=torch.where(keep, torch.where(cross, cvx, nvx), vx),
            vy=torch.where(keep, torch.where(cross, cvy, nvy), vy),
            in_edge=torch.where(keep & cross, torch.remainder(opp_e, 3), s["in_edge"]),
            active=active & ~finish & (opp_e >= 0),
        )

    state, _ = _run_steps(step, state, max_steps)
    final_t, final_p = _finish(state, t_idx, p)
    if with_diagnostics:
        return final_t, final_p, int(state["active"].sum())
    return final_t, final_p


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


def flow_field_trace_compacted_plain(tm: TraceMesh, vfield, times, t0, p0, min_step,
                                     max_steps: int = 4096, escalate: int = 16,
                                     check_every: int = CHECK_EVERY):
    """flow_field_trace with lane compaction and cap escalation, in plain
    PyTorch.

    Path lengths are heavy-tailed: between checks, once at most half of the
    marching lanes are live, the live ones are gathered into a smaller batch
    (the finished ones are written back). Lanes still live at ``max_steps``
    keep marching, up to ``escalate * max_steps`` steps in all, emulating the
    reference's effectively unbounded cap (1e6, FEM.inl:905). Per-lane
    results equal an uncompacted march of the same step budget.

    Returns (t1, p1, exhausted_count)."""
    tab = _tables(tm, vfield)
    full = _flow_init(tab, times, t0, p0, min_step)
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
