"""End-to-end surface optical-flow pipeline (the OpticalFlow app's engine).

Port of meshopticalflow_tpu/flow/pipeline.py with ``use_multigrid=False``:
  * init (WhitneyFlowViewer::Init, OpticalFlow.cpp:679-917): load inputs,
    subdivide, build the intrinsic mesh and chart-transition tables, bake
    textures to vertex signals, rasterize the texel sample table, exp-remap
    off-triangle texels, preprocess the comparison signals (log space / DoG
    band), build the Whitney basis;
  * per-level UpdateFlow (OpticalFlow.cpp:423-474): smooth -> advect +-1/2
    -> data term -> regularized Gauss-Newton step, solved with Jacobi-PCG
    inside float64 iterative refinement;
  * IterativeOptimization (OpticalFlow.cpp:1035-1056): coarse-to-fine weight
    schedule, then the final advection of both inputs to the halfway point
    and their blend.

Everything that runs per level or per texel runs on ``FlowProblem.device``;
the host does the mesh preprocessing and reads back a few scalars per level.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from meshopticalflow_tpu_torch.config import FlowConfig, require_supported
from meshopticalflow_tpu_torch.flow.signal import (
    SmoothingOperators, dog_band, log_space, make_smoothing_operators, smooth_signal)
from meshopticalflow_tpu_torch.geometry.mesh import HostMesh, build_mesh
from meshopticalflow_tpu_torch.geometry.rasterize import TextureSource, rasterize_texture_source
from meshopticalflow_tpu_torch.geometry.subdivide import subdivide_tracked
from meshopticalflow_tpu_torch.io.ply import read_triangle_mesh, write_ply_colored
from meshopticalflow_tpu_torch.io.png import read_png_rgb, write_png_rgb
from meshopticalflow_tpu_torch.kernels.advect import (
    _fetch_colors, build_quad_table, flow_field_trace_compacted, resample_signal,
    sample_vertex_signal, vertex_mean)
from meshopticalflow_tpu_torch.kernels.tracing import TraceMesh, exp_map, make_trace_mesh
from meshopticalflow_tpu_torch.models.base import BasisDevice, build_basis, update_optical_flow
from meshopticalflow_tpu_torch.ops.dataterm import data_term_blocks
from meshopticalflow_tpu_torch.ops.ell import ell_matvec


@dataclasses.dataclass
class ProblemArrays:
    """All static device tensors of a flow problem."""

    tm: TraceMesh
    smooth_ops: SmoothingOperators
    basis: BasisDevice
    signals: torch.Tensor    # (V, 2C) both comparison signals channel-stacked
    area: torch.Tensor       # (T,)


@dataclasses.dataclass
class FlowResult:
    coeffs: np.ndarray
    tfield: np.ndarray            # (T, 2) final flow field
    metrics: List[Dict]           # per-level metrics


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "float64": torch.float64}[name]


def resolve_device(device) -> torch.device:
    """The device a problem runs on. A CUDA device without a usable GPU
    raises: the port never falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but "
                               "torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (use cpu or cuda)")
    return dev


def _sync(device: torch.device) -> None:
    """Wait for the device so host clocks attribute time to the right stage."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


# ----------------------------------------------------------------------------
# Device stages
# ----------------------------------------------------------------------------

def _preprocess_signals(smooth_ops: SmoothingOperators, raw: torch.Tensor,
                        config: FlowConfig) -> torch.Tensor:
    """Comparison-signal construction (OpticalFlow.cpp:820-857).

    raw: (2, V, 3) -> (V, 2C) channel-stacked preprocessed signals."""
    sig = raw
    if config.log_space:
        sig = log_space(sig)
    if config.dog_weight > 0:
        stacked = torch.cat([sig[0], sig[1]], dim=1)                  # (V, 6)
        bands = dog_band(smooth_ops, stacked, config.dog_smooth,
                         tol=config.cg_tol, max_iters=config.cg_max_iters)
        if config.channels == 6:
            w = config.dog_weight
            out0 = torch.cat([sig[0] * (1 - w), bands[:, :3] * w], dim=1)
            out1 = torch.cat([sig[1] * (1 - w), bands[:, 3:] * w], dim=1)
            return torch.cat([out0, out1], dim=1)
        return bands
    return torch.cat([sig[0], sig[1]], dim=1)


def _stage_smooth(arrays: ProblemArrays, s_weight, config: FlowConfig):
    return smooth_signal(arrays.smooth_ops, arrays.signals, s_weight,
                         tol=config.cg_tol, max_iters=config.cg_max_iters)


def _trace_pair(tm: TraceMesh, tfield, dtype, min_step, max_steps):
    """Barycentre lanes advected by -1/2 (first half) and +1/2 (second), in
    one compacted march with cap escalation (the reference package's
    single-device path). Returns (t1, p1, exhausted-lane count)."""
    t_count, device = tm.n_triangles, tfield.device
    t0 = torch.arange(t_count, device=device).repeat(2)
    p0 = torch.full((2 * t_count, 2), 1.0 / 3.0, dtype=dtype, device=device)
    times = torch.cat([torch.full((t_count,), -0.5, dtype=dtype, device=device),
                       torch.full((t_count,), 0.5, dtype=dtype, device=device)])
    return flow_field_trace_compacted(tm, tfield, times, t0, p0, min_step, max_steps)


def _advected_vertex_signals(arrays: ProblemArrays, smoothed, t1, p1):
    """Sample both smoothed signals at the advected barycentre end points
    and push the per-triangle values back to vertices by segment mean
    (ResampleSignal, OpticalFlow.cpp:197-260). Returns (V, 2C): [:C] =
    signal 0 advected forward, [C:] = signal 1 advected backward."""
    c = arrays.signals.shape[1] // 2
    t_count = arrays.tm.n_triangles
    sampled = sample_vertex_signal(arrays.tm.triangles, smoothed, t1, p1)
    both = torch.cat([sampled[:t_count, :c], sampled[t_count:, c:]], dim=1)
    return vertex_mean(arrays.tm.triangles, both, smoothed.shape[0])


def _dataterm_from_samples(arrays: ProblemArrays, smoothed, t1, p1):
    c = arrays.signals.shape[1] // 2
    resampled = _advected_vertex_signals(arrays, smoothed, t1, p1)
    res0, res1 = resampled[:, :c], resampled[:, c:]
    d_blocks, rhs_t = data_term_blocks(arrays.tm.triangles, arrays.area, res0, res1)
    diff = res1 - res0
    mdiff = ell_matvec(arrays.smooth_ops.cols, arrays.smooth_ops.mass_vals, diff)
    align_err = torch.sum(diff * mdiff)
    return d_blocks, rhs_t, align_err


def _stage_resample(arrays: ProblemArrays, tfield, smoothed, config: FlowConfig):
    """Advect both smoothed signals by -1/2 / +1/2 and build the data term
    plus the alignment-error diagnostic (OpticalFlow.cpp:439-470, 1012-1023).
    Returns (d_blocks, rhs_t, align_err, exhausted, (t1, p1))."""
    t1, p1, exhausted = _trace_pair(arrays.tm, tfield, smoothed.dtype,
                                    config.flow_min_step, config.flow_max_steps)
    d_blocks, rhs_t, align_err = _dataterm_from_samples(arrays, smoothed, t1, p1)
    return d_blocks, rhs_t, align_err, exhausted, (t1, p1)


def _level_step(arrays: ProblemArrays, coeffs, tfield, s_weight, v_weight,
                config: FlowConfig, warm_x=None):
    """One UpdateFlow level (OpticalFlow.cpp:423-474): chunked-PCG smoothing,
    advection and data term, refined Jacobi-PCG flow solve.

    Returns (new_coeffs, new_tfield, metrics, x) with x the solved direction."""
    device = coeffs.device
    _t0 = time.time()
    smoothed, sm_stats = _stage_smooth(arrays, s_weight, config)
    _sync(device)
    _t1 = time.time()
    d_blocks, rhs_t, align_err, exhausted, _ = _stage_resample(
        arrays, tfield, smoothed, config)
    _sync(device)
    _t2 = time.time()
    new_coeffs, new_tfield, cg_stats, x = update_optical_flow(
        arrays.basis, coeffs, d_blocks, rhs_t, v_weight,
        cg_tol=config.cg_tol, cg_max_iters=config.cg_max_iters,
        refine=config.flow_refine, x0=warm_x)
    _sync(device)
    _t3 = time.time()
    metrics = dict(
        smooth_iters=float(sm_stats.iterations), smooth_res=float(sm_stats.rel_residual),
        flow_iters=float(cg_stats.iterations), flow_res=float(cg_stats.rel_residual),
        trace_exhausted=float(exhausted),
        smooth_seconds=_t1 - _t0, trace_seconds=_t2 - _t1,
        solve_seconds=_t3 - _t2,
        alignment_error=float(align_err))
    return new_coeffs, new_tfield, metrics, x


def _halfway_lanes(src_t_sorted, src_p_sorted, t_back: float, t_fwd: float):
    """Both textures' march lanes: start states and per-lane flow times."""
    t2 = torch.cat([src_t_sorted, src_t_sorted])
    p2 = torch.cat([src_p_sorted, src_p_sorted])
    n = src_t_sorted.shape[0]
    kw = dict(dtype=src_p_sorted.dtype, device=src_p_sorted.device)
    times = torch.cat([torch.full((n,), t_back, **kw), torch.full((n,), t_fwd, **kw)])
    return t2, p2, times


def _halfway_tail(c0, c1, order, src_t, tex0, tex1, h: int, w: int):
    """Scatter the sampled colours back to raster order, fill unclaimed
    texels with the input blend, blend, clip and truncate to uint8."""
    accum_s = c0 + c1
    accum = torch.zeros_like(accum_s).index_copy(0, order, accum_s)
    base = (torch.flip(tex0, [0]) + torch.flip(tex1, [0])).reshape(-1, 3)
    accum = torch.where((src_t >= 0)[:, None], accum, base)
    blend = (accum / 2.0).reshape(h, w, 3)
    return torch.clamp(blend, 0, 255).to(torch.uint8)


# ----------------------------------------------------------------------------
# Host helpers (copies of the reference package's numpy code)
# ----------------------------------------------------------------------------

def _host_sample_texture(texture: np.ndarray, uv: np.ndarray, bilinear: bool) -> np.ndarray:
    """numpy clone of the reference texture fetch (MeshFlow.inl:65-84)."""
    h, w = texture.shape[:2]
    tex = texture.astype(np.float64)
    x = np.clip(uv[:, 0], 0, 1) * (w - 1)
    y = np.clip(1.0 - uv[:, 1], 0, 1) * (h - 1)
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    if not bilinear:
        return tex[y0, x0]
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    dx, dy = (x - x0)[:, None], (y - y0)[:, None]
    return (tex[y0, x0] * (1 - dx) * (1 - dy) + tex[y0, x1] * dx * (1 - dy)
            + tex[y1, x1] * dx * dy + tex[y1, x0] * (1 - dx) * dy)


def sample_texture_to_vertices(triangles: np.ndarray, uvs: np.ndarray,
                               texture: np.ndarray, n_vertices: int,
                               bilinear: bool = True) -> np.ndarray:
    """Per-wedge texture average into vertex colors (MeshFlow.inl:251-266)."""
    samples = _host_sample_texture(texture, uvs.reshape(-1, 2), bilinear)
    colors = np.zeros((n_vertices, 3))
    counts = np.zeros(n_vertices)
    np.add.at(colors, triangles.ravel(), samples)
    np.add.at(counts, triangles.ravel(), 1.0)
    return colors / np.maximum(counts, 1)[:, None]


def load_texture_geometry(mesh_path: str, edge_length_fraction: float):
    """PLY parse and tracked subdivision of a textured mesh
    (OpticalFlow.cpp:684-752). Returns (triangles, vertices, face_uvs)."""
    data = read_triangle_mesh(mesh_path)
    if data.face_uvs is None:
        raise ValueError(f"{mesh_path} has no texture coordinates")
    diag = float(np.linalg.norm(data.vertices.max(0) - data.vertices.min(0)))
    tris, verts, uvs = data.faces, data.vertices, data.face_uvs
    edge_len = edge_length_fraction * diag
    if edge_len > 0:
        tris, verts, uvs, _, _ = subdivide_tracked(tris, verts, uvs, edge_len)
    return tris, verts, uvs


class FlowProblem:
    """A prepared optical-flow problem: its device tensors and level loop."""

    def __init__(
        self,
        config: FlowConfig,
        mesh: HostMesh,
        signals: np.ndarray,               # (2, V, 3) raw input signals
        vertices: Optional[np.ndarray] = None,
        texture_source: Optional[TextureSource] = None,
        tri_uvs: Optional[np.ndarray] = None,
        textures: Optional[np.ndarray] = None,       # (2, H, W, 3) uint8
        vertex_colors: Optional[np.ndarray] = None,  # (2, V, 3)
        device="cpu",
    ):
        require_supported(config)
        self.config = config
        self.device = resolve_device(device)
        self.dtype = torch_dtype(config.dtype)
        self.mesh = mesh
        self.vertices = vertices
        self.init_profile: Dict[str, float] = {}
        kw = dict(dtype=self.dtype, device=self.device)
        _t = time.time()

        def _mark(name):
            nonlocal _t
            _sync(self.device)
            self.init_profile[name] = time.time() - _t
            _t = time.time()

        tm = make_trace_mesh(mesh, self.dtype, self.device)
        smooth_ops = make_smoothing_operators(mesh, self.dtype, self.device)
        _mark("device_tables")
        self.basis_host, basis = build_basis(mesh, config, self.device)
        _mark("basis")
        raw = torch.as_tensor(np.asarray(signals)).to(**kw)
        self.arrays = ProblemArrays(
            tm=tm, smooth_ops=smooth_ops, basis=basis,
            signals=_preprocess_signals(smooth_ops, raw, config),
            area=torch.as_tensor(mesh.area).to(**kw))
        _mark("preprocess_signals")

        self.texture_source = texture_source
        self.textures = None if textures is None else \
            torch.as_tensor(np.asarray(textures)).to(**kw)
        self.tri_uvs = None if tri_uvs is None else \
            torch.as_tensor(np.asarray(tri_uvs)).to(**kw)
        self.vertex_colors = None if vertex_colors is None else \
            torch.as_tensor(np.asarray(vertex_colors)).to(**kw)
        self._exp_exhausted = None
        if texture_source is not None:
            self.src_t = torch.as_tensor(texture_source.tri_idx).to(
                device=self.device, dtype=torch.int64)
            self.src_p = torch.as_tensor(texture_source.bary).to(**kw)
            self._exp_remap_texels()
        _mark("exp_remap")
        self.coeffs = torch.zeros(basis.n_coeffs, **kw)
        self.tfield = torch.zeros((mesh.n_triangles, 2), **kw)
        self._warm_x = None
        self._advect_order = None
        self._quad_tables = None

    # -- construction ----------------------------------------------------

    @classmethod
    def from_texture_inputs(cls, mesh_path: str, texture_paths: Tuple[str, str],
                            config: FlowConfig, device="cpu") -> "FlowProblem":
        """Texture-pair alignment setup (WhitneyFlowViewer::Init texture
        branch, OpticalFlow.cpp:684-752 + 818)."""
        _t0 = time.time()
        tris, verts, uvs = load_texture_geometry(mesh_path,
                                                 config.subdivide_edge_length)
        mesh = build_mesh(tris, vertices=verts)
        geom_s = time.time() - _t0
        tex0 = read_png_rgb(texture_paths[0])
        tex1 = read_png_rgb(texture_paths[1])
        if tex0.shape != tex1.shape:
            raise ValueError(f"texture shapes differ: {tex0.shape} vs {tex1.shape}")
        n_vertices = int(tris.max()) + 1
        _t0 = time.time()
        signals = np.stack([sample_texture_to_vertices(tris, uvs, t, n_vertices,
                                                       not config.nearest)
                            for t in (tex0, tex1)])
        bake_s = time.time() - _t0
        h, w = tex0.shape[:2]
        _t0 = time.time()
        src = rasterize_texture_source(uvs, w, h, config.pad_radius)
        raster_s = time.time() - _t0
        problem = cls(config, mesh, signals, vertices=verts, texture_source=src,
                      tri_uvs=uvs, textures=np.stack([tex0, tex1]), device=device)
        problem.init_profile.update(geom=geom_s, bake=bake_s, raster=raster_s)
        return problem

    @classmethod
    def from_vertex_inputs(cls, path0: str, path1: str, config: FlowConfig,
                           device="cpu") -> "FlowProblem":
        """Colored-PLY-pair setup (OpticalFlow.cpp:753-780): identical
        connectivity required; geometry is the average of the two."""
        m0 = read_triangle_mesh(path0)
        m1 = read_triangle_mesh(path1)
        if m0.vertices.shape != m1.vertices.shape:
            raise ValueError("vertex counts differ")
        if not np.array_equal(m0.faces, m1.faces):
            raise ValueError("triangle indices do not match")
        if m0.colors is None or m1.colors is None:
            raise ValueError("inputs must carry per-vertex colors")
        verts = (m0.vertices + m1.vertices) * 0.5
        mesh = build_mesh(m0.faces, vertices=verts)
        return cls(config, mesh, np.stack([m0.colors, m1.colors]), vertices=verts,
                   vertex_colors=np.stack([m0.colors, m1.colors]), device=device)

    def _exp_remap_texels(self) -> None:
        """Push out-of-triangle texels through the geodesic exp
        (RemapSamplePoint, MeshFlow.inl:339-350)."""
        mask = self.texture_source.needs_remap
        if not mask.any():
            return
        idx = torch.as_tensor(np.nonzero(mask)[0]).to(self.device)
        t_in = self.src_t[idx]
        p_in = self.src_p[idx]
        center = torch.full_like(p_in, 1.0 / 3.0)
        t1, p1, exhausted = exp_map(self.arrays.tm, t_in, center, p_in - center,
                                    with_diagnostics=True)
        self.src_t = self.src_t.index_copy(0, idx, t1)
        self.src_p = self.src_p.index_copy(0, idx, p1)
        self._exp_exhausted = exhausted

    # -- outer loop (IterativeOptimization, OpticalFlow.cpp:1035-1056) ---

    def run(self, verbose: bool = False, checkpoint_dir: Optional[str] = None,
            resume: bool = True) -> FlowResult:
        """Coarse-to-fine optimization; optionally checkpoints each level to
        ``checkpoint_dir`` and resumes from the latest checkpoint there."""
        cfg = self.config
        coeffs, tfield = self.coeffs, self.tfield
        s_weight = cfg.scalar_smooth_weight
        v_weight = cfg.resolved_vf_smooth_weight()
        start_level = 0
        if checkpoint_dir:
            os.makedirs(checkpoint_dir, exist_ok=True)
            if resume:
                ckpts = sorted(glob.glob(os.path.join(checkpoint_dir, "level_*.npz")))
                if ckpts:
                    lvl, s_weight, v_weight = self.load_checkpoint(ckpts[-1])
                    coeffs, tfield = self.coeffs, self.tfield
                    start_level = lvl + 1
        metrics: List[Dict] = []
        warm_x = self._warm_x if cfg.flow_warm_start else None
        self._warm_x = None
        for level in range(start_level, cfg.levels):
            t0 = time.time()
            coeffs, tfield, stats, x = _level_step(
                self.arrays, coeffs, tfield, s_weight, v_weight, cfg, warm_x=warm_x)
            if cfg.flow_warm_start:
                warm_x = x
            if level == start_level and self._exp_exhausted is not None:
                stats["exp_remap_exhausted"] = float(self._exp_exhausted)
                self._exp_exhausted = None
            stats.update(level=level, s_weight=s_weight, v_weight=v_weight,
                         seconds=time.time() - t0)
            if stats.get("exp_remap_exhausted", 0):
                print(f"[WARNING] exp remap: {int(stats['exp_remap_exhausted'])} "
                      f"texel lanes hit the step cap", file=sys.stderr)
            if stats["trace_exhausted"] > 0:
                # The reference warns per-lane on cap exhaustion (FEM.inl:897).
                print(f"[WARNING] level {level}: "
                      f"{int(stats['trace_exhausted'])} trace lanes hit the "
                      f"step cap mid-path", file=sys.stderr)
            metrics.append(stats)
            if verbose:
                print(json.dumps({k: (float(f"{v:.6g}") if isinstance(v, float) else v)
                                  for k, v in stats.items()}))
            s_weight *= cfg.scalar_weight_multiplier
            if v_weight * cfg.vf_weight_multiplier > cfg.vf_smooth_weight_threshold:
                v_weight = v_weight * cfg.vf_weight_multiplier
            if checkpoint_dir:
                self.coeffs, self.tfield = coeffs, tfield
                self.save_checkpoint(
                    os.path.join(checkpoint_dir, f"level_{level:03d}.npz"),
                    level, s_weight, v_weight, warm_x=warm_x)
        self.coeffs, self.tfield = coeffs, tfield
        return FlowResult(_to_numpy(coeffs), _to_numpy(tfield), metrics)

    # -- final outputs ---------------------------------------------------

    def advected_vertex_colors(self, alpha: float = 0.5) -> np.ndarray:
        """Advect the original input colors to the halfway point
        (InputGeometryData::flow, OpticalFlow.cpp:476-490). Returns (2, V, 3)."""
        cfg = self.config
        outs = []
        for s in range(2):
            length = -alpha if s == 0 else 1.0 - alpha
            outs.append(_to_numpy(resample_signal(
                self.arrays.tm, self.tfield, self.vertex_colors[s], length,
                cfg.flow_min_step, cfg.flow_max_steps)))
        return np.stack(outs)

    def _ensure_advect_order(self) -> None:
        """March lanes sorted by starting triangle, so neighbouring lanes
        read neighbouring table rows; outputs scatter back to raster order."""
        if self._advect_order is None:
            order = torch.argsort(self.src_t, stable=True)
            self._advect_order = order
            self._advect_src_t = self.src_t[order]
            self._advect_src_p = self.src_p[order]

    def _ensure_quad_tables(self):
        if self._quad_tables is None:
            self._quad_tables = tuple(build_quad_table(self.textures[s])
                                      for s in range(2))
        return self._quad_tables

    def halfway_texture(self, alpha: float = 0.5) -> np.ndarray:
        """(H, W, 3) uint8 halfway blend (the --out result), blended and
        quantized on the device (OutputImage, OpticalFlow.cpp:1044-1047).

        Both textures' lanes march in one compacted trace, with per-lane
        flow times -alpha and 1-alpha."""
        cfg = self.config
        src = self.texture_source
        h, w = src.height, src.width
        _t0 = time.time()
        self._ensure_advect_order()
        n = self._advect_src_t.shape[0]
        t2, p2, times = _halfway_lanes(self._advect_src_t, self._advect_src_p,
                                       -alpha, 1.0 - alpha)
        t1, p1, exhausted = flow_field_trace_compacted(
            self.arrays.tm, self.tfield, times, t2, p2,
            cfg.flow_min_step, cfg.flow_max_steps)
        if exhausted:
            print(f"[WARNING] texture advection: {exhausted} texel lanes "
                  f"hit the step cap", file=sys.stderr)
        quads = self._ensure_quad_tables() if not cfg.nearest else (None, None)
        c0 = _fetch_colors(self.tri_uvs, self.textures[0], t1[:n], p1[:n],
                           not cfg.nearest, quad=quads[0])
        c1 = _fetch_colors(self.tri_uvs, self.textures[1], t1[n:], p1[n:],
                           not cfg.nearest, quad=quads[1])
        q = _halfway_tail(c0, c1, self._advect_order, self.src_t,
                          self.textures[0], self.textures[1], h, w)
        result = _to_numpy(q)
        secs = time.time() - _t0
        self.last_advect_stats = {
            "seconds": secs, "texels_per_sec": 2 * h * w / max(secs, 1e-9),
            "exhausted": exhausted}
        return result

    def save_checkpoint(self, path: str, level: int, s_weight: float,
                        v_weight: float, warm_x=None) -> None:
        """Mid-run checkpoint of the optimization state, in the reference
        package's format (its checkpoints load here and the other way round)."""
        extra = {} if warm_x is None else {"warm_x": _to_numpy(warm_x)}
        np.savez(path, coeffs=_to_numpy(self.coeffs), tfield=_to_numpy(self.tfield),
                 level=level, s_weight=s_weight, v_weight=v_weight, **extra)

    def load_checkpoint(self, path: str):
        kw = dict(dtype=self.dtype, device=self.device)
        with np.load(path) as data:
            self.coeffs = torch.as_tensor(data["coeffs"]).to(**kw)
            self.tfield = torch.as_tensor(data["tfield"]).to(**kw)
            self._warm_x = (torch.as_tensor(data["warm_x"]).to(**kw)
                            if "warm_x" in data else None)
            return int(data["level"]), float(data["s_weight"]), float(data["v_weight"])

    def write_output(self, path: str, alpha: float = 0.5) -> None:
        """Blend the two advected inputs and write (OpticalFlow.cpp:1044-1055)."""
        if self.texture_source is not None:
            blend = self.halfway_texture(alpha)
            write_png_rgb(path, np.flipud(blend))  # flipY (OpticalFlow.cpp:1047)
        else:
            adv = self.advected_vertex_colors(alpha)
            blend = (adv[0] + adv[1]) / 2.0
            write_ply_colored(path, self.vertices, blend, self.mesh.triangles, fmt="ascii")
