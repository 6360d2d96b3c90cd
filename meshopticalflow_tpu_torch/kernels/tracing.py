"""Geodesic tracing on the intrinsic mesh.

Port of meshopticalflow_tpu/kernels/tracing.py: the reference triangle
marches as batched, masked iteration over all lanes (texels or triangle
barycentres) at once.

  * ``flow_field_trace``: advect a point along a piecewise-constant
    per-triangle field for a given flow time, re-reading the field every
    ``min_step`` of metric arc length and stopping on direction reversal
    (FEM::RiemannianMesh::flow, FEM.inl:901-994);
  * ``whitney_flow_trace``: the same march along the Whitney field of signed
    half-edge coefficients, evaluated at the current point (FEM.inl:998-1100);
  * ``gradient_flow_trace`` and ``flow_field_trace_distance``: descent along
    -grad f, and the distance-accumulating flow (FEM.inl:1102-1278);
  * ``exp_map``: straight-line geodesic of a Hermite sample, used to remap
    out-of-chart texels (FEM.inl:834-899).

On CUDA tensors ``flow_field_trace``, ``whitney_flow_trace`` and ``exp_map``
(and kernels/advect.py:flow_field_trace_compacted) launch the hand-written
kernels of ``csrc/trace.cu`` (one thread per lane, marching to its own end
or step budget; march_field and march_whitney read one row of
``march_rows`` a crossing), or raise; the reference package runs these
marches as XLA while_loops with no Pallas kernel. On CPU tensors they run
their plain PyTorch versions (``*_plain``), whose arithmetic the kernels
repeat op for op, so that end points agree bit for bit. Each launch counts
into utils/spans.py's counter table under ``launch.<kernel>``, and a
wrapper's under ``launch.<kernel>/<wrapper>`` too, which
``<wrapper>.launches`` reads; each plain version counts the calls it gets
with CUDA tensors in ``<plain>.cuda_calls``. ``gradient_flow_trace`` and
``flow_field_trace_distance`` are on no CLI's path and stay plain PyTorch.

A plain step is a fixed sequence of elementwise tensor ops plus five
gathers (metric and field by triangle; opposite edge, transition map and
offset by half-edge). Lanes that stop keep their state frozen, so extra
steps are no-ops: the loops test for live lanes every ``check_every`` steps
(a host sync each) and still stop at ``max_steps`` exactly.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from meshopticalflow_tpu_torch.geometry.mesh import HostMesh
from meshopticalflow_tpu_torch.kernels.build import (
    NVCC_FLAGS, CudaLibrary, raise_on, stream_of)
from meshopticalflow_tpu_torch.utils import spans

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
    """The mesh's tracing tables on ``device``; the march kernels' rows are
    packed from them at the first CUDA march (``march_rows``)."""
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
    """Flat per-triangle and per-half-edge tables one march step reads, and
    the field the march follows: a per-triangle vector (``field``) or the
    Whitney 1-form of signed half-edge coefficients (``ce``, with the
    inverse metric ``g_inv4``). ``triangles`` is set when lanes stop on a
    target vertex."""

    g3: torch.Tensor      # (T, 3): g00, g01, g11
    opp: torch.Tensor     # (3T,)
    lin: torch.Tensor     # (3T, 4) row-major 2x2
    const: torch.Tensor   # (3T, 2)
    field: Optional[torch.Tensor] = None    # (T, 2)
    ce: Optional[torch.Tensor] = None       # (T, 3)
    g_inv4: Optional[torch.Tensor] = None   # (T, 4) row-major 2x2
    triangles: Optional[torch.Tensor] = None  # (T, 3)

    def field_at(self, t, px, py):
        """The field the march follows, at chart point (px, py) of triangle
        t: the triangle's vector, or the Whitney field evaluated there
        (GetWhitneyVector, FEM.inl:1008-1014). Returns (vx, vy)."""
        if self.ce is None:
            vf = self.field[t]
            return vf[:, 0], vf[:, 1]
        c = self.ce[t]
        c0, c1, c2 = c[:, 0], c[:, 1], c[:, 2]
        u = c2 * (1 - py) - py * (c1 + c0)
        w = px * (c0 + c2) - (1 - px) * c1
        return _transform(self.g_inv4[t], None, u, w)


def _tables(tm: TraceMesh, vfield: Optional[torch.Tensor] = None,
            ce: Optional[torch.Tensor] = None) -> _Tables:
    dtype = tm.g.dtype
    g3 = torch.stack([tm.g[:, 0, 0], tm.g[:, 0, 1], tm.g[:, 1, 1]], -1)
    tab = _Tables(g3, tm.opp, tm.xform_linear.reshape(-1, 4), tm.xform_const.reshape(-1, 2))
    if ce is not None:
        tab.ce = ce.to(dtype).reshape(-1, 3)
        tab.g_inv4 = tm.g_inv.reshape(-1, 4)
    elif vfield is not None:
        tab.field = vfield.to(dtype)
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
    """One march step of FEM::RiemannianMesh::flow (FEM.inl:901-994), or of
    whitneyFlow (FEM.inl:998-1100) when the tables hold a Whitney field: the
    field is re-read through ``tab.field_at`` at the advanced point. A state
    with ``total`` accumulates the flow time advanced; one with ``target``
    stops a lane on entering a triangle that holds its target vertex
    (gradientFlow, FEM.inl:1187)."""
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
    if "target" in s:
        hit_target = do_cross & (tab.triangles[new_t] == s["target"][:, None]).any(dim=1)
        still_active = still_active & ~hit_target
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
    if "target" in s:
        out["target"] = s["target"]
    if "total" in s:
        total = s["total"] + torch.where(active, adv, torch.zeros_like(adv))
        out["total"] = torch.where(keep, total, s["total"])
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


def flow_field_trace_plain(
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
    if p.is_cuda:
        flow_field_trace_plain.cuda_calls += 1
    tab = _tables(tm, vfield)
    state = _flow_init(tab, flow_time, t_idx, p, min_step)
    state, _ = _run_steps(lambda s: _flow_step(s, tab, min_step, eps), state,
                          max_steps)
    final_t, final_p = _finish(state, t_idx, p)
    if with_diagnostics:
        return final_t, final_p, int(state["active"].sum())
    return final_t, final_p


def whitney_flow_trace_plain(
    tm: TraceMesh,
    ce: torch.Tensor,           # (3T,) signed half-edge Whitney coefficients
    flow_time,
    t_idx: torch.Tensor,
    p: torch.Tensor,
    min_step: float,
    max_steps: int = 4096,
    eps: float = 0.0,
    with_diagnostics: bool = False,
):
    """Batched FEM::RiemannianMesh::whitneyFlow (FEM.inl:998-1100): the march
    of ``flow_field_trace`` with the Whitney field re-evaluated at the
    current point. ``flow_time`` may be scalar or per-lane (N,);
    ``with_diagnostics`` appends the cap-exhausted lane count."""
    if p.is_cuda:
        whitney_flow_trace_plain.cuda_calls += 1
    tab = _tables(tm, ce=ce)
    state = _flow_init(tab, flow_time, t_idx, p, min_step)
    state, _ = _run_steps(lambda s: _flow_step(s, tab, min_step, eps), state, max_steps)
    final_t, final_p = _finish(state, t_idx, p)
    if with_diagnostics:
        return final_t, final_p, int(state["active"].sum())
    return final_t, final_p


def gradient_flow_trace(
    tm: TraceMesh,
    f: torch.Tensor,            # (V,) per-vertex potential
    t_idx: torch.Tensor,        # (N,) starting triangles
    p: torch.Tensor,            # (N, 2) starting points
    min_step: float,
    target_vertex=-1,           # scalar or (N,) vertex index terminating lanes
    max_steps: int = 4096,
    eps: float = 0.0,
):
    """Batched FEM::RiemannianMesh::gradientFlow (FEM.inl:1102-1202):
    descend along -grad f, re-reading the gradient every ``min_step`` of arc
    length, stopping on direction reversal, at the boundary, or on entering
    a triangle that holds ``target_vertex``. The march of
    ``flow_field_trace`` on the per-triangle field -grad f, with no flow-time
    limit. Returns (t, p, total_time)."""
    n = p.shape[0]
    tri = tm.triangles
    gx, gy = _transform(tm.g_inv.reshape(-1, 4), None, f[tri[:, 1]] - f[tri[:, 0]],
                        f[tri[:, 2]] - f[tri[:, 0]])
    tab = _tables(tm, torch.stack([-gx, -gy], -1))
    tab.triangles = tri
    state = _flow_init(tab, float("inf"), t_idx, p, min_step)
    state["target"] = torch.as_tensor(target_vertex, device=p.device).to(torch.int64).expand(n)
    state["total"] = torch.zeros(n, dtype=p.dtype, device=p.device)
    state, _ = _run_steps(lambda s: _flow_step(s, tab, min_step, eps), state, max_steps)
    final_t, final_p = _finish(state, t_idx, p)
    return final_t, final_p, state["total"]


def flow_field_trace_distance(
    tm: TraceMesh,
    vfield: torch.Tensor,
    flow_time,
    t_idx: torch.Tensor,
    p: torch.Tensor,
    max_steps: int = 4096,
    eps: float = 0.0,
):
    """Batched distance-accumulating flow overload (FEM.inl:1204-1278):
    advects by flow time with the field re-read only at crossings, stopping
    where the carried vector opposes the next triangle's field, and
    accumulating metric arc length. Returns (t, p, distance).

    Its step is not ``_flow_step``'s: it never re-reads the field inside a
    triangle, tests reversal against the next triangle's field before it
    moves (a lane that stops, at a reversal or the boundary, stays where it
    was instead of advancing to the edge), and takes the new triangle's
    field after a crossing instead of carrying the transformed vector.
    Only the edge exit and the transition tables are shared."""
    dtype, device = p.dtype, p.device
    n = p.shape[0]
    tab = _tables(tm, vfield)
    flow_time = torch.as_tensor(flow_time, dtype=dtype, device=device).expand(n)
    direction = torch.where(flow_time < 0, -1.0, 1.0).to(dtype)
    t_safe = torch.clamp(t_idx.to(torch.int64), min=0)
    v0 = tab.field[t_safe] * direction[:, None]
    state = dict(t=t_safe, px=p[:, 0].clone(), py=p[:, 1].clone(),
                 vx=v0[:, 0].contiguous(), vy=v0[:, 1].contiguous(),
                 ft=torch.abs(flow_time).clone(),
                 dist=torch.zeros(n, dtype=dtype, device=device),
                 in_edge=torch.full((n,), -1, dtype=torch.int64, device=device),
                 active=t_idx >= 0)

    def step(s):
        t, px, py, vx, vy, ft = s["t"], s["px"], s["py"], s["vx"], s["vy"], s["ft"]
        active = s["active"] & (vx * vx + vy * vy > 0)
        step_s, idx = _edge_exit(px, py, vx, vy, s["in_edge"], eps)
        active = active & (idx >= 0)
        v_len = torch.sqrt(torch.clamp(_metric_dot(tab.g3[t], vx, vy, vx, vy), min=0.0))
        finish = step_s > ft
        e = t * 3 + torch.clamp(idx, min=0)
        opp_e = tab.opp[e]
        cross = active & ~finish
        hit_boundary = cross & (opp_e < 0)
        nb = torch.div(torch.clamp(opp_e, min=0), 3, rounding_mode="floor")
        lin = tab.lin[e]
        cvx, cvy = _transform(lin, None, vx, vy)
        fnb = tab.field[nb]
        # Reversal is checked before stepping to the edge (FEM.inl:1264-1266):
        # the lane stops where it is.
        reversal = cross & (opp_e >= 0) & (
            _metric_dot(tab.g3[nb], cvx, cvy, fnb[:, 0], fnb[:, 1]) * direction < 0)
        do_cross = cross & (opp_e >= 0) & ~reversal
        zero = torch.zeros_like(ft)
        adv = torch.where(finish, ft, torch.where(do_cross, step_s, zero))
        adv = torch.where(active, adv, zero)
        npx, npy = px + vx * adv, py + vy * adv
        new_t = torch.where(do_cross, nb, t)
        cpx, cpy = _transform(lin, tab.const[e], npx, npy)
        fnew = tab.field[new_t]
        keep = s["active"]
        return dict(
            t=torch.where(keep, new_t, t),
            px=torch.where(keep, torch.where(do_cross, cpx, npx), px),
            py=torch.where(keep, torch.where(do_cross, cpy, npy), py),
            vx=torch.where(keep, torch.where(do_cross, fnew[:, 0] * direction, vx), vx),
            vy=torch.where(keep, torch.where(do_cross, fnew[:, 1] * direction, vy), vy),
            ft=torch.where(keep, ft - adv, ft),
            dist=torch.where(keep, s["dist"] + v_len * adv, s["dist"]),
            in_edge=torch.where(keep & do_cross, torch.remainder(opp_e, 3), s["in_edge"]),
            active=active & ~finish & ~hit_boundary & ~reversal)

    state, _ = _run_steps(step, state, max_steps)
    final_t, final_p = _finish(state, t_idx, p)
    return final_t, final_p, state["dist"]


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
    if p.is_cuda:
        exp_map_plain.cuda_calls += 1
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


flow_field_trace_plain.cuda_calls = 0
whitney_flow_trace_plain.cuda_calls = 0
exp_map_plain.cuda_calls = 0


# -- the CUDA kernels (csrc/trace.cu) ------------------------------------------

_TAGS = {torch.float32: "f32", torch.float64: "f64"}
KERNELS = ("march_field", "march_whitney", "exp_map")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i64, f64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    march = [p, p, p, p, p, p, p, p, p, p, i64, i64, f64, f64, i64, p, p, p, p]
    exp = [p, p, p, p, p, p, i64, f64, i64, p, p, p, p]
    for tag in _TAGS.values():
        for name, args in ((f"march_field_{tag}", march), (f"march_whitney_{tag}", march),
                           (f"exp_map_{tag}", exp)):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


# -fmad=false: no a * b + c contracted into one rounding, as the plain
# version's separate elementwise ops round each product and sum.
LIBRARY = CudaLibrary("trace", "trace.cu", _bind, flags=NVCC_FLAGS + ("-fmad=false",))
# each kernel's last launch: (lanes, device int64 [exhausted, lane-steps, max
# lane-steps, warp-step slots])
LAST_STATS: Dict[str, tuple] = {}
# a row's values (l0 l1 l2 l3, c0 c1, the opposite triangle's g00 g01 g11,
# the opposite half-edge as int32, padding) and the int32 word of the
# opposite: 48 bytes in float32, 80 in float64 (csrc/trace.cu:Row)
ROW_LAYOUT = {torch.float32: (12, 9), torch.float64: (10, 18)}


def march_rows(tm: TraceMesh) -> torch.Tensor:
    """The march kernels' per-half-edge rows (3T, width) in the tables'
    float type (``ROW_LAYOUT``): the transition map (4 values), its offset
    (2), the opposite triangle's metric g00 g01 g11 (zero on the boundary)
    and the opposite half-edge as int32, so a crossing reads one row and
    nothing after it. Packed once a ``TraceMesh`` and kept on it; raises
    where 3T does not fit int32."""
    rows = tm.__dict__.get("_march_rows")
    if rows is not None:
        return rows
    half_edges = tm.opp.shape[0]
    if half_edges >= 2 ** 31:
        raise ValueError(f"march rows: {half_edges} half-edges; the march kernels index "
                         f"them as int32 (3T < 2^31)")
    dtype = tm.g.dtype
    if dtype not in ROW_LAYOUT:
        raise TypeError(f"march rows: mesh tables must be float32 or float64, got {dtype}")
    width, opp_word = ROW_LAYOUT[dtype]
    rows = torch.zeros((half_edges, width), dtype=dtype, device=tm.opp.device)
    rows[:, 0:4] = tm.xform_linear.reshape(-1, 4)
    rows[:, 4:6] = tm.xform_const.reshape(-1, 2)
    g = tm.g.reshape(-1, 4)[torch.div(tm.opp.clamp(min=0), 3, rounding_mode="floor")]
    rows[:, 6:9] = torch.where((tm.opp >= 0)[:, None], g[:, [0, 1, 3]], 0.0)
    rows.view(torch.int32)[:, opp_word] = tm.opp.to(torch.int32)
    tm.__dict__["_march_rows"] = rows
    return rows


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a copy of it where its data is not aligned to two values
    (the march kernels load the field and the metrics as 2-vectors)."""
    return x if x.data_ptr() % (2 * x.element_size()) == 0 else x.clone()


def _operands(name: str, tm: TraceMesh, t_idx: torch.Tensor, p: torch.Tensor, *lane_f):
    """Validate and normalise a march's operands: every tensor on p's CUDA
    device, p (N, 2) in the mesh tables' float type; returns (t_idx int64,
    p, *lane_f) contiguous. The kernels trust the indices: t_idx below the
    triangle count, as every caller builds them."""
    dev, dtype = p.device, p.dtype
    if dtype not in _TAGS:
        raise TypeError(f"{name}: points must be float32 or float64, got {dtype}")
    if tm.g.dtype != dtype:
        raise TypeError(f"{name}: mesh tables are {tm.g.dtype}, points {dtype}")
    if p.dim() != 2 or p.shape[1] != 2 or t_idx.shape != p.shape[:1]:
        raise ValueError(f"{name}: t_idx (N,) and p (N, 2) expected, got "
                         f"{tuple(t_idx.shape)} and {tuple(p.shape)}")
    tensors = (tm.g, tm.opp, tm.xform_linear, tm.xform_const, t_idx, *lane_f)
    if any(x.device != dev for x in tensors):
        raise ValueError(f"{name}: operands on different devices "
                         f"({sorted({str(x.device) for x in tensors + (p,)})})")
    return (t_idx.to(torch.int64).contiguous(), p.contiguous(),
            *(x.to(dtype).contiguous() for x in lane_f))


def _call(kernel: str, dtype, dev, n: int, args) -> tuple:
    """Launch ``kernel`` for ``n`` lanes on dev's current stream; returns
    (t_out, p_out, stats)."""
    t_out = torch.empty(n, dtype=torch.int64, device=dev)
    p_out = torch.empty((n, 2), dtype=dtype, device=dev)
    stats = torch.zeros(4, dtype=torch.int64, device=dev)
    fn = getattr(LIBRARY.load(), f"{kernel}_{_TAGS[dtype]}")
    with torch.cuda.device(dev):
        err = fn(*args, t_out.data_ptr(), p_out.data_ptr(), stats.data_ptr(), stream_of(dev))
    raise_on(err, kernel)
    if n:
        spans.count("launch." + kernel)
    LAST_STATS[kernel] = (n, stats)
    return t_out, p_out, stats


def march(tm: TraceMesh, flow_time, t_idx: torch.Tensor, p: torch.Tensor, min_step: float,
          budget: int, eps: float = 0.0, vfield: Optional[torch.Tensor] = None,
          ce: Optional[torch.Tensor] = None) -> tuple:
    """One launch of march_field (per-triangle ``vfield`` (T, 2)) or
    march_whitney (Whitney coefficients ``ce`` (3T,)): every lane steps until
    it stops or has taken ``budget`` steps. Returns (t, p, stats), stats the
    device int64 [exhausted lanes, lane-steps, max lane-steps, warp-step
    slots]; nothing is read back."""
    whitney = ce is not None
    name = "march_whitney" if whitney else "march_field"
    field = ce.reshape(-1) if whitney else vfield
    n = p.shape[0]
    ft = torch.as_tensor(flow_time, dtype=p.dtype, device=p.device)
    if ft.numel() == 1:
        ft, ft_stride = ft.reshape(1), 0
    elif ft.shape == (n,):
        ft_stride = 1
    else:
        raise ValueError(f"{name}: flow_time must be a scalar or (N,), got {tuple(ft.shape)}")
    t_idx, p, field, ft, *g_inv = _operands(name, tm, t_idx, p, field, ft,
                                            *((tm.g_inv,) if whitney else ()))
    want = (3 * tm.n_triangles,) if whitney else (tm.n_triangles, 2)
    if field.shape != want:
        raise ValueError(f"{name}: field of {tuple(field.shape)}, {want} expected")
    field = field if whitney else _aligned(field)
    g_inv = [_aligned(x) for x in g_inv]
    tables = [march_rows(tm), _aligned(tm.g.contiguous())] + [
        x.contiguous() for x in (tm.opp, tm.xform_linear, tm.xform_const)]
    args = [x.data_ptr() for x in (*tables, field)]
    args += [g_inv[0].data_ptr() if whitney else 0] + [x.data_ptr() for x in (t_idx, p, ft)]
    return _call(name, p.dtype, p.device, n,
                 args + [ft_stride, n, float(min_step), float(eps), int(budget)])


def march_exp(tm: TraceMesh, t_idx: torch.Tensor, p: torch.Tensor, v: torch.Tensor,
              budget: int, eps: float = 0.0) -> tuple:
    """One launch of the exp_map kernel; returns (t, p, stats) as ``march``."""
    n = p.shape[0]
    t_idx, p, v = _operands("exp_map", tm, t_idx, p, v)
    if v.shape != p.shape:
        raise ValueError(f"exp_map: v {tuple(v.shape)} for p {tuple(p.shape)}")
    tables = [x.contiguous() for x in (tm.opp, tm.xform_linear, tm.xform_const)]
    args = [x.data_ptr() for x in (*tables, t_idx, p, v)]
    return _call("exp_map", p.dtype, p.device, n, args + [n, float(eps), int(budget)])


@spans.launches("launch.march_field/flow_field_trace")
def flow_field_trace(tm: TraceMesh, vfield: torch.Tensor, flow_time, t_idx: torch.Tensor,
                     p: torch.Tensor, min_step: float, max_steps: int = 4096,
                     eps: float = 0.0, with_diagnostics: bool = False):
    """Batched FEM::RiemannianMesh::flow (FEM.inl:901-994) along the
    per-triangle field ``vfield`` (T, 2) for ``flow_time`` (scalar or (N,),
    sign = direction) from (t_idx (N,), p (N, 2)), at most ``max_steps``
    steps a lane. Returns final (t_idx, p); lanes with t_idx < 0 pass
    through unchanged. ``with_diagnostics`` appends the number of lanes
    still live when the cap stopped them (the reference warns per lane on
    cap exhaustion, FEM.inl:897,992). CUDA tensors: march_field."""
    if not p.is_cuda:
        return flow_field_trace_plain(tm, vfield, flow_time, t_idx, p, min_step, max_steps,
                                      eps, with_diagnostics)
    t1, p1, stats = march(tm, flow_time, t_idx, p, min_step, max_steps, eps, vfield=vfield)
    spans.count(flow_field_trace.key, int(p.shape[0] > 0))
    return (t1, p1, int(stats[0])) if with_diagnostics else (t1, p1)


@spans.launches("launch.march_whitney/whitney_flow_trace")
def whitney_flow_trace(tm: TraceMesh, ce: torch.Tensor, flow_time, t_idx: torch.Tensor,
                       p: torch.Tensor, min_step: float, max_steps: int = 4096,
                       eps: float = 0.0, with_diagnostics: bool = False):
    """Batched FEM::RiemannianMesh::whitneyFlow (FEM.inl:998-1100): the march
    of ``flow_field_trace`` along the Whitney field of the signed half-edge
    coefficients ``ce`` (3T,), re-evaluated at the current point.
    ``flow_time`` may be scalar or per-lane (N,); ``with_diagnostics``
    appends the cap-exhausted lane count. CUDA tensors: march_whitney."""
    if not p.is_cuda:
        return whitney_flow_trace_plain(tm, ce, flow_time, t_idx, p, min_step, max_steps,
                                        eps, with_diagnostics)
    t1, p1, stats = march(tm, flow_time, t_idx, p, min_step, max_steps, eps, ce=ce)
    spans.count(whitney_flow_trace.key, int(p.shape[0] > 0))
    return (t1, p1, int(stats[0])) if with_diagnostics else (t1, p1)


@spans.launches("launch.exp_map/exp_map")
def exp_map(tm: TraceMesh, t_idx: torch.Tensor, p: torch.Tensor, v: torch.Tensor,
            max_steps: int = 1024, eps: float = 0.0, with_diagnostics: bool = False):
    """Batched FEM::RiemannianMesh::exp (FEM.inl:834-899): straight-line
    geodesic carrying the displacement ``v`` (N, 2) of the starting chart
    across charts. ``with_diagnostics`` appends the cap-exhausted lane
    count. CUDA tensors: the exp_map kernel."""
    if not p.is_cuda:
        return exp_map_plain(tm, t_idx, p, v, max_steps, eps, with_diagnostics)
    t1, p1, stats = march_exp(tm, t_idx, p, v, max_steps, eps)
    spans.count(exp_map.key, int(p.shape[0] > 0))
    return (t1, p1, int(stats[0])) if with_diagnostics else (t1, p1)


def last_stats(kernel: str) -> dict:
    """The last launch of ``kernel``: lanes, exhausted lanes, lane-steps,
    the largest lane's steps and the warp-step slots (32 x the loop
    iterations each warp ran; lane-steps / slots is the SIMT efficiency),
    in one read from the device."""
    n, stats = LAST_STATS[kernel]
    exhausted, total, top, slots = (int(v) for v in stats.cpu())
    return dict(lanes=n, exhausted=exhausted, lane_steps=total, max_lane_steps=top,
                warp_slots=slots)


def _wrappers_and_plains():
    from meshopticalflow_tpu_torch.kernels import advect

    return ((flow_field_trace, whitney_flow_trace, exp_map,
             advect.flow_field_trace_compacted),
            (flow_field_trace_plain, whitney_flow_trace_plain, exp_map_plain,
             advect.flow_field_trace_compacted_plain))


def reset_counts() -> None:
    """Zero the launch counts and the plain-on-CUDA call counts."""
    _, plains = _wrappers_and_plains()
    spans.clear(*(f"launch.{k}" for k in KERNELS))
    for fn in plains:
        fn.cuda_calls = 0


def counts() -> dict:
    """Launches per kernel and per wrapper, and plain-version calls on CUDA
    tensors."""
    wrappers, plains = _wrappers_and_plains()
    out = {k: spans.counter("launch." + k) for k in KERNELS}
    out["by_wrapper"] = {fn.__name__: fn.launches for fn in wrappers}
    out["plain_on_cuda"] = sum(fn.cuda_calls for fn in plains)
    return out
