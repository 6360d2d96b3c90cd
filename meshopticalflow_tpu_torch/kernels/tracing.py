"""Geodesic tracing on the intrinsic mesh.

Port of meshopticalflow_tpu/kernels/tracing.py: the reference triangle
marches as batched, masked iteration over all lanes (texels or triangle
barycentres) at once.

  * ``flow_field_trace``: advect a point along a piecewise-constant
    per-triangle field for a given flow time, re-reading the field every
    ``min_step`` of metric arc length and stopping on direction reversal
    (FEM::RiemannianMesh::flow, FEM.inl:901-994);
  * ``exp_map``: straight-line geodesic of a Hermite sample, used to remap
    out-of-chart texels (FEM.inl:834-899).

A step is a fixed sequence of elementwise tensor ops plus five gathers
(metric and field by triangle; opposite edge, transition map and offset by
half-edge). Lanes that stop keep their state frozen, so extra steps are
no-ops: the loops test for live lanes every ``check_every`` steps (a host
sync each) and still stop at ``max_steps`` exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from meshopticalflow_tpu_torch.geometry.mesh import HostMesh

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


def make_trace_mesh(mesh: HostMesh, dtype=torch.float32, device="cpu") -> TraceMesh:
    def dev(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    return TraceMesh(
        triangles=dev(mesh.triangles, torch.int64),
        g=dev(mesh.g, dtype),
        g_inv=dev(mesh.g_inv, dtype),
        area=dev(mesh.area, dtype),
        opp=dev(mesh.opp, torch.int64),
        xform_linear=dev(mesh.xform_linear, dtype),
        xform_const=dev(mesh.xform_const, dtype),
    )


@dataclasses.dataclass
class _Tables:
    """Flat per-triangle and per-half-edge tables one march step reads."""

    g3: torch.Tensor      # (T, 3): g00, g01, g11
    opp: torch.Tensor     # (3T,)
    lin: torch.Tensor     # (3T, 4) row-major 2x2
    const: torch.Tensor   # (3T, 2)
    field: Optional[torch.Tensor] = None   # (T, 2)


def _tables(tm: TraceMesh, vfield: Optional[torch.Tensor] = None) -> _Tables:
    g3 = torch.stack([tm.g[:, 0, 0], tm.g[:, 0, 1], tm.g[:, 1, 1]], -1)
    field = None if vfield is None else vfield.to(tm.g.dtype)
    return _Tables(g3, tm.opp, tm.xform_linear.reshape(-1, 4),
                   tm.xform_const.reshape(-1, 2), field)


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


def _flow_init(vfield, flow_time, t_idx, p, min_step) -> Dict[str, torch.Tensor]:
    dtype, device = p.dtype, p.device
    n = p.shape[0]
    flow_time = torch.as_tensor(flow_time, dtype=dtype, device=device).expand(n)
    direction = torch.where(flow_time < 0, -1.0, 1.0).to(dtype)
    t_safe = torch.clamp(t_idx.to(torch.int64), min=0)
    v0 = vfield.to(dtype)[t_safe] * direction[:, None]
    return dict(
        t=t_safe,
        px=p[:, 0].clone(), py=p[:, 1].clone(),
        vx=v0[:, 0].contiguous(), vy=v0[:, 1].contiguous(),
        ft=torch.abs(flow_time).clone(),
        step_left=torch.full((n,), min_step, dtype=dtype, device=device),
        in_edge=torch.full((n,), -1, dtype=torch.int64, device=device),
        direction=direction,
        active=(t_idx >= 0) & ((v0 * v0).sum(-1) > 0),
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
    vf = tab.field[t]
    vfx, vfy = vf[:, 0], vf[:, 1]
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
    return dict(
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


def flow_field_trace(
    tm: TraceMesh,
    vfield: torch.Tensor,       # (T, 2) per-triangle field (chart coordinates)
    flow_time,                  # scalar or (N,) flow time (sign = direction)
    t_idx: torch.Tensor,        # (N,) starting triangles (may be -1: inactive)
    p: torch.Tensor,            # (N, 2) starting barycentric points
    min_step: float,
    max_steps: int = 4096,
    eps: float = 0.0,
    with_diagnostics: bool = False,
):
    """Batched FEM::RiemannianMesh::flow (FEM.inl:901-994). Returns final
    (t_idx, p); lanes with t_idx < 0 pass through unchanged.

    ``with_diagnostics`` appends the number of lanes still live when the
    ``max_steps`` cap stopped the march (the reference warns per lane on cap
    exhaustion, FEM.inl:897,992)."""
    state = _flow_init(vfield, flow_time, t_idx, p, min_step)
    tab = _tables(tm, vfield)
    state, _ = _run_steps(lambda s: _flow_step(s, tab, min_step, eps), state,
                          max_steps)
    final_t, final_p = _finish(state, t_idx, p)
    if with_diagnostics:
        return final_t, final_p, int(state["active"].sum())
    return final_t, final_p


def exp_map(
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
