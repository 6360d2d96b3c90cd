"""The geodesic march, one lane at a time, against the batched plain march.

csrc/trace.cu's kernels march each lane alone: from its start, step after
step until it stops or has spent its budget, in the plain version's order
of operations (kernels/tracing.py). ``LaneMarch`` below is that control
flow in numpy scalars of the march's type, so on the CPU it stands for the
kernels, which need a card. It must equal the batched plain march
(``*_plain``) bit for bit, in float32 and float64, for the field, Whitney
and exp_map forms, on a closed sphere and on a flat grid with a boundary,
with inactive lanes, zero fields, boundary hits, reversals, both signs of
flow time and budgets that bind; and it must agree with the reference
package's marches in float64 within the tracing tests' BARY_TOL.

Square roots: torch's CPU ``sqrt`` is not correctly rounded (it differs
from IEEE in about 1 % of float32 and float64 values on an AVX-512 build);
CUDA's, which both the kernels and the plain version on the card use, is.
The bit-for-bit comparisons with the CPU plain march therefore take the
square root from torch on the CPU, and the JAX comparison takes IEEE's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meshopticalflow_tpu.geometry.mesh import build_mesh
from meshopticalflow_tpu.kernels import tracing as j_tracing
from meshopticalflow_tpu_torch.kernels import advect as t_advect
from meshopticalflow_tpu_torch.kernels import build, probes, spmv
from meshopticalflow_tpu_torch.kernels import tracing as t_tracing
from meshopticalflow_tpu_torch.utils.testing import flat_grid, march_lanes, octa_sphere

torch.set_num_threads(1)

BARY_TOL = 1e-10          # tests/test_torch_tracing.py
LANES = 400
MIN_STEP = 1e-2
_TORCH = {np.float32: torch.float32, np.float64: torch.float64}


def _torch_sqrt(f):
    dt = _TORCH[f]
    return lambda x: f(torch.sqrt(torch.tensor([x], dtype=dt)).item())


def _ieee_sqrt(f):
    return lambda x: f(np.sqrt(f(x)))


class LaneMarch:
    """The kernels' per-lane march in numpy scalars of type ``f``."""

    def __init__(self, tm: t_tracing.TraceMesh, f, sqrt, eps: float = 0.0):
        def host(x):
            return x.detach().cpu().numpy()

        self.f, self.sqrt = f, sqrt
        self.g = host(tm.g).reshape(-1, 4).astype(f)
        self.g_inv = host(tm.g_inv).reshape(-1, 4).astype(f)
        self.opp = [int(o) for o in host(tm.opp)]
        self.lin = host(tm.xform_linear).reshape(-1, 4).astype(f)
        self.cst = host(tm.xform_const).reshape(-1, 2).astype(f)
        self.lo, self.hi = f(-eps), f(1.0 + eps)

    def edge_exit(self, px, py, vx, vy, in_edge):
        f = self.f
        best, best_idx = f(0), -1
        for num, den, fp, fv, idx in ((-py, vy, px, vx, 2), (-px, vx, py, vy, 1),
                                      ((f(1) - px) - py, vx + vy, px, vx, 0)):
            if den != 0:
                s = num / den
                foo = fp + fv * s
                if (in_edge != idx and s > 0 and foo >= self.lo and foo <= self.hi
                        and s > best):
                    best, best_idx = s, idx
        return best, best_idx

    @staticmethod
    def metric_dot(g, ax, ay, bx, by):
        return (ax * g[0] + ay * g[1]) * bx + (ax * g[1] + ay * g[3]) * by

    def field_at(self, field, t, px, py):
        if field.ndim == 2:
            return field[t, 0], field[t, 1]
        f = self.f
        c0, c1, c2 = field[3 * t], field[3 * t + 1], field[3 * t + 2]
        u = c2 * (f(1) - py) - py * (c1 + c0)
        w = px * (c0 + c2) - (f(1) - px) * c1
        l = self.g_inv[t]
        return l[0] * u + l[1] * w, l[2] * u + l[3] * w

    def transform(self, e, px, py, vx, vy):
        l, c = self.lin[e], self.cst[e]
        return ((l[0] * px + l[1] * py) + c[0], (l[2] * px + l[3] * py) + c[1],
                l[0] * vx + l[1] * vy, l[2] * vx + l[3] * vy)

    def flow_lane(self, field, t, px, py, flow_time, min_step, budget):
        """One lane of flow / whitneyFlow; returns (t, px, py, live, steps,
        why it stopped)."""
        f = self.f
        direction = f(-1) if flow_time < 0 else f(1)
        ft = abs(flow_time)
        vx, vy = self.field_at(field, t, px, py)
        vx, vy = vx * direction, vy * direction
        step_left, in_edge = f(min_step), -1
        active = vx * vx + vy * vy > 0
        steps, why = 0, "budget" if active else "zero field"
        while active and steps < budget:
            steps += 1
            live = vx * vx + vy * vy > 0
            step, idx = self.edge_exit(px, py, vx, vy, in_edge)
            why = "no exit" if live and idx < 0 else why
            live = live and idx >= 0
            g = self.g[t]
            vgv = self.metric_dot(g, vx, vy, vx, vy)
            sq_step = vgv * step * step
            update = min_step > 0 and sq_step > step_left * step_left
            if update:
                step = step_left / self.sqrt(vgv if vgv > 0 else f(1))
            finish = ft < step
            adv = ft if finish else step
            npx, npy = px + vx * adv, py + vy * adv
            ft = ft - adv
            why = "finished" if live and finish else why
            live = live and not finish
            if live and update:
                fx, fy = self.field_at(field, t, npx, npy)
                reversal = self.metric_dot(g, vx, vy, fx, fy) * direction < 0
                vx, vy = fx * direction, fy * direction
                step_left, in_edge = f(min_step), -1
                live = not reversal
                why = "reversal" if reversal else why
            elif live:
                e = 3 * t + idx
                o = self.opp[e]
                if o < 0:
                    live, why = False, "boundary"
                else:
                    npx, npy, vx, vy = self.transform(e, npx, npy, vx, vy)
                    t, in_edge = o // 3, o % 3
                    step_left = step_left - self.sqrt(f(0) if sq_step < 0 else sq_step)
            px, py, active = npx, npy, live
        return t, px, py, active, steps, why

    def exp_lane(self, t, px, py, vx, vy, budget):
        """One lane of exp; returns (t, px, py, live, steps)."""
        f = self.f
        active = vx * vx + vy * vy > 0
        in_edge, idx = -1, -1
        if px <= 0 and vx < 0:
            idx = 1
        elif py <= 0 and vy < 0:
            idx = 2
        elif px + py >= 1 and vx + vy > 0:
            idx = 0
        if active and idx != -1:
            e = 3 * t + idx
            o = self.opp[e]
            if o >= 0:
                px, py, vx, vy = self.transform(e, px, py, vx, vy)
                t, in_edge = o // 3, o % 3
        steps = 0
        while active and steps < budget:
            steps += 1
            s, idx = self.edge_exit(px, py, vx, vy, in_edge)
            finish = s > 1
            if finish:
                npx, npy, nvx, nvy = px + vx, py + vy, f(0), f(0)
            else:
                rest = f(1) - s
                npx, npy, nvx, nvy = px + vx * s, py + vy * s, vx * rest, vy * rest
            live = idx >= 0 and not finish
            if live:
                e = 3 * t + idx
                o = self.opp[e]
                if o < 0:
                    live = False
                else:
                    npx, npy, nvx, nvy = self.transform(e, npx, npy, nvx, nvy)
                    t, in_edge = o // 3, o % 3
            px, py, vx, vy, active = npx, npy, nvx, nvy, live
        return t, px, py, active, steps

    def run(self, t0, p0, budget, field=None, times=None, v=None, min_step=MIN_STEP):
        """Every lane; returns (t (N,) int64, p (N, 2), exhausted lanes)."""
        f = self.f
        t0, p0 = np.asarray(t0), np.asarray(p0).astype(f)
        times = np.broadcast_to(np.asarray(times, f), t0.shape) if times is not None else None
        v = np.asarray(v).astype(f) if v is not None else None
        field = np.asarray(field).astype(f) if field is not None else None
        t_out, p_out, exhausted = t0.astype(np.int64), p0.copy(), 0
        for i in range(len(t0)):
            if t0[i] < 0:
                continue
            if v is not None:
                out = self.exp_lane(int(t0[i]), p0[i, 0], p0[i, 1], v[i, 0], v[i, 1], budget)
            else:
                out = self.flow_lane(field, int(t0[i]), p0[i, 0], p0[i, 1], times[i],
                                     min_step, budget)
            t_out[i], p_out[i, 0], p_out[i, 1] = out[0], out[1], out[2]
            exhausted += int(out[3])
        return t_out, p_out, exhausted


@pytest.fixture(scope="module", params=["sphere", "flat"])
def surface(request):
    tris, verts = octa_sphere(3) if request.param == "sphere" else flat_grid(9)
    mesh = build_mesh(tris, vertices=verts, make_unit_area=request.param == "sphere")
    return dict(name=request.param, mesh=mesh,
                lanes=march_lanes(mesh.opp, LANES, seed=3))


# (form, budget, flow time, min_step): "compacted" is flow_field_trace_compacted
# at max_steps 16, escalate 2 (a budget of 32 steps a lane).
CASES = {
    "field_7": ("field", 7, "lanes", MIN_STEP),
    "field_4096": ("field", 4096, "lanes", MIN_STEP),
    "field_scalar_time": ("field", 4096, -0.7, MIN_STEP),
    "field_no_min_step": ("field", 4096, "lanes", 0.0),
    "compacted_16x2": ("compacted", 32, "lanes", MIN_STEP),
    "whitney_7": ("whitney", 7, "lanes", MIN_STEP),
    "whitney_4096": ("whitney", 4096, 0.7, MIN_STEP),
    "exp_3": ("exp", 3, None, None),
    "exp_1024": ("exp", 1024, None, None),
}


def _plain(tm, form, budget, ft, min_step, lanes, dtype):
    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a)).to(dt)

    t0, p0 = t(lanes["t0"], torch.int64), t(lanes["p0"])
    times = t(lanes["times"]) if isinstance(ft, str) else ft
    if form == "field":
        return t_tracing.flow_field_trace_plain(tm, t(lanes["field"]), times, t0, p0, min_step,
                                                budget, with_diagnostics=True)
    if form == "compacted":
        return t_advect.flow_field_trace_compacted_plain(tm, t(lanes["field"]), times, t0, p0,
                                                         min_step, max_steps=16, escalate=2,
                                                         check_every=8)
    if form == "whitney":
        return t_tracing.whitney_flow_trace_plain(tm, t(lanes["ce"]), times, t0, p0, min_step,
                                                  budget, with_diagnostics=True)
    return t_tracing.exp_map_plain(tm, t0, p0, t(lanes["v"]), budget, with_diagnostics=True)


def _lane_march(march, form, budget, ft, min_step, lanes):
    if form == "exp":
        return march.run(lanes["t0"], lanes["p0"], budget, v=lanes["v"])
    times = lanes["times"] if isinstance(ft, str) else ft
    field = lanes["ce"] if form == "whitney" else lanes["field"]
    return march.run(lanes["t0"], lanes["p0"], budget, field=field, times=times,
                     min_step=min_step)


@pytest.mark.parametrize("f", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(CASES))
def test_lane_march_equals_plain_bit_for_bit(surface, case, f):
    form, budget, ft, min_step = CASES[case]
    dtype = _TORCH[f]
    tm = t_tracing.make_trace_mesh(surface["mesh"], dtype)
    lanes = surface["lanes"]
    t_ref, p_ref, exhausted_ref = _plain(tm, form, budget, ft, min_step, lanes, dtype)
    t_lane, p_lane, exhausted = _lane_march(LaneMarch(tm, f, _torch_sqrt(f)), form, budget,
                                            ft, min_step, lanes)
    np.testing.assert_array_equal(t_lane, t_ref.numpy())
    assert p_ref.dtype == dtype
    np.testing.assert_array_equal(p_lane, p_ref.numpy())     # bit for bit
    assert exhausted == exhausted_ref
    if budget <= 7:
        assert exhausted > 0                          # the budget binds
    moved = (t_lane != lanes["t0"]) | (p_lane != lanes["p0"].astype(f)).any(1)
    assert moved[lanes["t0"] >= 0].any()
    assert not moved[lanes["t0"] < 0].any()           # inactive lanes pass through


def test_lanes_cover_the_edge_cases(surface):
    """The lane set starts lanes on a zero field, and its lanes finish
    inside a triangle, stop on a reversal and (on the flat grid) on the
    boundary, and run out of a budget of 7 steps."""
    f = np.float64
    tm = t_tracing.make_trace_mesh(surface["mesh"], torch.float64)
    march = LaneMarch(tm, f, _ieee_sqrt(f))
    lanes = surface["lanes"]
    field = lanes["field"].astype(f)
    seen = set()
    for budget in (7, 4096):
        for i in np.nonzero(lanes["t0"] >= 0)[0]:
            out = march.flow_lane(field, int(lanes["t0"][i]), f(lanes["p0"][i, 0]),
                                  f(lanes["p0"][i, 1]), f(lanes["times"][i]), MIN_STEP, budget)
            seen.add(out[5])
    want = {"zero field", "finished", "reversal", "budget"}
    if surface["name"] == "flat":
        want.add("boundary")
    assert want <= seen, seen


@pytest.fixture(scope="module")
def jax_surface(surface):
    mesh = surface["mesh"]
    return dict(surface, tm_j=j_tracing.make_trace_mesh(mesh, jnp.float64),
                tm_t=t_tracing.make_trace_mesh(mesh, torch.float64))


@pytest.mark.parametrize("form", ["field", "whitney", "exp"])
def test_lane_march_matches_reference_package(jax_surface, form):
    s = jax_surface
    lanes = s["lanes"]
    t0, p0 = jnp.asarray(lanes["t0"], jnp.int32), jnp.asarray(lanes["p0"])
    if form == "field":
        ref = j_tracing.flow_field_trace(s["tm_j"], jnp.asarray(lanes["field"]),
                                         jnp.asarray(lanes["times"]), t0, p0, MIN_STEP,
                                         max_steps=4096, with_diagnostics=True)
    elif form == "whitney":
        ref = j_tracing.whitney_flow_trace(s["tm_j"], jnp.asarray(lanes["ce"]),
                                           jnp.asarray(lanes["times"]), t0, p0, MIN_STEP,
                                           max_steps=4096, with_diagnostics=True)
    else:
        ref = j_tracing.exp_map(s["tm_j"], t0, p0, jnp.asarray(lanes["v"]), max_steps=1024,
                                with_diagnostics=True)
    march = LaneMarch(s["tm_t"], np.float64, _ieee_sqrt(np.float64))
    t1, p1, exhausted = _lane_march(march, form, 1024 if form == "exp" else 4096, "lanes",
                                    MIN_STEP, lanes)
    np.testing.assert_array_equal(t1, np.asarray(ref[0]))
    np.testing.assert_allclose(p1, np.asarray(ref[1]), rtol=0, atol=BARY_TOL)
    assert exhausted == int(ref[2])


# -- routing: CPU tensors take the plain versions ---------------------------------

def _wrapper_calls(tm, lanes):
    def t(a, dt=torch.float64):
        return torch.as_tensor(np.asarray(a)).to(dt)

    t0, p0 = t(lanes["t0"], torch.int64), t(lanes["p0"])
    return {
        "flow_field_trace": lambda: t_tracing.flow_field_trace(
            tm, t(lanes["field"]), t(lanes["times"]), t0, p0, MIN_STEP, 64),
        "whitney_flow_trace": lambda: t_tracing.whitney_flow_trace(
            tm, t(lanes["ce"]), 0.5, t0, p0, MIN_STEP, 64),
        "exp_map": lambda: t_tracing.exp_map(tm, t0, p0, t(lanes["v"]), 64),
        "flow_field_trace_compacted": lambda: t_advect.flow_field_trace_compacted(
            tm, t(lanes["field"]), t(lanes["times"]), t0, p0, MIN_STEP, 16, escalate=2),
    }


@pytest.mark.parametrize("wrapper", ["flow_field_trace", "whitney_flow_trace", "exp_map",
                                     "flow_field_trace_compacted"])
def test_cpu_tensors_take_the_plain_version(surface, wrapper):
    tm = t_tracing.make_trace_mesh(surface["mesh"], torch.float64)
    t_tracing.reset_counts()
    out = _wrapper_calls(tm, surface["lanes"])[wrapper]()
    counts = t_tracing.counts()
    assert counts["by_wrapper"][wrapper] == 0
    assert all(counts[k] == 0 for k in t_tracing.KERNELS)
    assert counts["plain_on_cuda"] == 0
    assert out[0].device.type == "cpu" and out[0].dtype == torch.int64


def test_wrapper_equals_plain_on_cpu(surface):
    tm = t_tracing.make_trace_mesh(surface["mesh"], torch.float64)
    lanes = surface["lanes"]
    t0 = torch.as_tensor(lanes["t0"])
    p0 = torch.as_tensor(lanes["p0"])
    field = torch.as_tensor(lanes["field"])
    a = t_tracing.flow_field_trace(tm, field, 0.6, t0, p0, MIN_STEP, with_diagnostics=True)
    b = t_tracing.flow_field_trace_plain(tm, field, 0.6, t0, p0, MIN_STEP,
                                         with_diagnostics=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and a[2] == b[2]


# -- build: the march library's nvcc flags -----------------------------------------

def test_march_library_builds_without_fma_contraction():
    cmd = t_tracing.LIBRARY.command("out.so", compiler="nvcc")
    assert "-fmad=false" in cmd
    assert "--use_fast_math" not in cmd and "-use_fast_math" not in cmd
    assert cmd[-1].endswith("csrc/trace.cu")
    assert cmd[1:1 + len(build.NVCC_FLAGS)] == list(build.NVCC_FLAGS)


@pytest.mark.parametrize("library", ["spmv", "probes"])
def test_other_libraries_keep_their_nvcc_command(library):
    lib = {"spmv": spmv.LIBRARY, "probes": probes.LIBRARY}[library]
    assert lib.command("out.so", compiler="nvcc") == [
        "nvcc", *build.NVCC_FLAGS, "-o", "out.so", str(lib.source)]
    assert "-fmad=false" not in build.NVCC_FLAGS


def test_library_path_follows_its_flags():
    lib = t_tracing.LIBRARY
    same = build.CudaLibrary(lib.stem, lib.source.name, t_tracing._bind, flags=lib.flags)
    other = build.CudaLibrary(lib.stem, lib.source.name, t_tracing._bind)
    assert same.path() == lib.path()
    assert other.path() != lib.path()


# -- the march kernels' rows and stats -------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_march_rows_equal_their_tables(surface, dtype):
    tm = t_tracing.make_trace_mesh(surface["mesh"], dtype)
    rows = t_tracing.march_rows(tm)
    n = 3 * tm.n_triangles
    width, opp_word = t_tracing.ROW_LAYOUT[dtype]
    assert rows.shape == (n, width) and rows.dtype == dtype
    assert rows.element_size() * width == (48 if dtype == torch.float32 else 80)
    assert torch.equal(rows[:, 0:4], tm.xform_linear.reshape(-1, 4))
    assert torch.equal(rows[:, 4:6], tm.xform_const.reshape(-1, 2))
    inner = tm.opp >= 0
    assert bool((~inner).any()) == (surface["name"] == "flat")      # boundary rows
    g = tm.g.reshape(-1, 4)[tm.opp[inner] // 3]                     # the opposite's metric
    assert torch.equal(rows[inner, 6:9], g[:, [0, 1, 3]])
    assert not rows[~inner, 6:9].any()
    words = rows.view(torch.int32)
    assert torch.equal(words[:, opp_word].to(torch.int64), tm.opp)
    rest = torch.ones(words.shape[1], dtype=torch.bool)
    rest[:opp_word + 1] = False
    assert not words[:, rest].any()                                # padding is zero
    assert t_tracing.march_rows(tm) is rows                        # packed once a mesh


def _shape_only_mesh(n_triangles: int) -> t_tracing.TraceMesh:
    """A TraceMesh of meta tensors: shapes, no storage."""
    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    n = 3 * n_triangles
    return t_tracing.TraceMesh(
        triangles=meta(n_triangles, 3, dtype=torch.int64), g=meta(n_triangles, 2, 2),
        g_inv=meta(n_triangles, 2, 2), area=meta(n_triangles),
        opp=meta(n, dtype=torch.int64), xform_linear=meta(n, 2, 2), xform_const=meta(n, 2))


@pytest.mark.parametrize("n_triangles", [715_827_883, 10 ** 9])
def test_march_rows_refuse_half_edges_past_int32(n_triangles):
    assert 3 * n_triangles >= 2 ** 31
    with pytest.raises(ValueError, match="int32"):
        t_tracing.march_rows(_shape_only_mesh(n_triangles))


def test_march_rows_take_half_edges_below_int32():
    rows = t_tracing.march_rows(_shape_only_mesh(715_827_882))
    assert rows.shape == (3 * 715_827_882, 12) and rows.is_meta


def test_last_stats_reports_warp_slots():
    saved = t_tracing.LAST_STATS.get("march_field")
    t_tracing.LAST_STATS["march_field"] = (7, torch.tensor([1, 50, 9, 96]))
    try:
        assert t_tracing.last_stats("march_field") == dict(
            lanes=7, exhausted=1, lane_steps=50, max_lane_steps=9, warp_slots=96)
    finally:
        if saved is None:
            del t_tracing.LAST_STATS["march_field"]
        else:
            t_tracing.LAST_STATS["march_field"] = saved


# -- march_sweep.py's cases: built from csrc/trace.cu by text replacement ----------

def _march_sweep():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "march_sweep.py"
    spec = importlib.util.spec_from_file_location("march_sweep", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("case", list(_march_sweep().CASES))
def test_march_sweep_case_applies_to_trace_cu(case):
    """Every lever's text is in csrc/trace.cu once, so each case (and the
    "pr13" case that chip_smoke.py builds) still builds from the source."""
    sweep = _march_sweep()
    src = sweep.case_source(sweep.CASES[case])
    shipped = (build.CSRC / "trace.cu").read_text()
    assert (src == shipped) == (case == "shipped")
    for name in ("march_field_f32", "march_field_f64", "march_whitney_f32",
                 "march_whitney_f64", "exp_map_f32", "exp_map_f64"):
        assert src.count(f"({name}, ") + src.count(f"int {name}(") == 1
