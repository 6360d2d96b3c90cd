"""The reference alignment of a texture pair and its halfway blend, by the
reference CLI's equations (OpticalFlow.cpp:684-1056), on plain tensors:
the tracked subdivision of the root mesh, the texel table with its exp
remap, the Whitney basis, the DoG comparison signals, then per level the
screened-Poisson smoothing, the barycentre trace, the data term and the
flow solve, each solve a plain Jacobi-PCG to a tolerance far below the
program's; then the halfway march, fetch and blend.

``store`` rounds each stage's result to a storage precision: the identity
for the reference, a round trip through bfloat16 for the control."""

from __future__ import annotations

import numpy as np
import torch

from pbref.cg import jacobi_pcg
from pbref.fem import coo_slot_map, ell_from_scipy, ell_matvec, scalar_mass_csr, \
    scalar_stiffness_csr
from pbref.mesh import build_mesh
from pbref.ply import read_textured_ply
from pbref.rasterize import rasterize_texture_source
from pbref.subdivide import subdivide_tracked
from pbref.trace import (_fetch_colors, exp_map_plain, flow_field_trace_compacted_plain,
                         make_trace_mesh, sample_vertex_signal, vertex_mean)
from pbref.whitney import build_basis, data_term_blocks, flow_step, flow_system

SOLVE_TOL = 1e-10


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def bf16_store(x: torch.Tensor) -> torch.Tensor:
    """The control's storage: a round trip through bfloat16."""
    return x.to(torch.bfloat16).to(x.dtype)


def bake(tris, uvs, texture: np.ndarray, n_vertices: int) -> np.ndarray:
    """Per-wedge bilinear texture average into vertex colours
    (MeshFlow.inl:65-84, 251-266), float64 on the host."""
    h, w = texture.shape[:2]
    tex = texture.astype(np.float64)
    uv = uvs.reshape(-1, 2)
    x = np.clip(uv[:, 0], 0, 1) * (w - 1)
    y = np.clip(1.0 - uv[:, 1], 0, 1) * (h - 1)
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    dx, dy = (x - x0)[:, None], (y - y0)[:, None]
    samples = (tex[y0, x0] * (1 - dx) * (1 - dy) + tex[y0, x1] * dx * (1 - dy)
               + tex[y1, x1] * dx * dy + tex[y1, x0] * (1 - dx) * dy)
    colors = np.zeros((n_vertices, 3))
    counts = np.zeros(n_vertices)
    np.add.at(colors, tris.ravel(), samples)
    np.add.at(counts, tris.ravel(), 1.0)
    return colors / np.maximum(counts, 1)[:, None]


class ReferenceFlow:
    """One mesh at one atlas size: ``align`` two textures, ``halfway`` blend
    them along a flow. ``flags`` are the configuration file's CLI flags."""

    def __init__(self, root_ply: str, flags: dict, width: int, height: int, device,
                 dtype=torch.float64):
        self.flags, self.device, self.dtype = flags, device, dtype
        self.width, self.height = width, height
        faces, verts, uvs = read_textured_ply(root_ply)
        diag = float(np.linalg.norm(verts.max(0) - verts.min(0)))
        tris, verts, uvs, _, _ = subdivide_tracked(faces, verts, uvs,
                                                   flags["eLength"] * diag)
        self.tris, self.uvs = tris, uvs
        mesh = build_mesh(tris, vertices=verts)
        self.n_vertices = mesh.n_vertices
        self.n_triangles = mesh.n_triangles
        kw = dict(dtype=dtype, device=device)
        self.tm = make_trace_mesh(mesh, dtype, device)
        self.area = torch.as_tensor(mesh.area).to(**kw)
        self.basis = build_basis(mesh, dtype, device)
        mass, stiff = scalar_mass_csr(mesh), scalar_stiffness_csr(mesh)
        cols, _, diag_slot = ell_from_scipy((mass + stiff).tocsr())

        def fill(csr):
            coo = csr.tocoo()
            vals = np.zeros(cols.size, np.float64)
            np.add.at(vals, coo_slot_map(cols, coo.row, coo.col), coo.data)
            return torch.as_tensor(vals.reshape(cols.shape)).to(**kw)

        self.v_cols = torch.as_tensor(cols).to(device)
        self.mass, self.stiff = fill(mass), fill(stiff)
        self.v_diag_slot = torch.as_tensor(diag_slot).to(device)
        lumped = np.zeros(mesh.n_vertices)
        np.add.at(lumped, tris.ravel(), np.repeat(mesh.area / 3.0, 3))
        self.lumped = torch.as_tensor(lumped).to(**kw)
        self.tri_uvs = torch.as_tensor(uvs).to(**kw)
        src = rasterize_texture_source(uvs, width, height, int(flags["pad"]))
        self.src_t = torch.as_tensor(src.tri_idx).to(device=device, dtype=torch.int64)
        self.src_p = torch.as_tensor(src.bary).to(**kw)
        idx = torch.as_tensor(np.nonzero(src.needs_remap)[0]).to(device)
        if idx.numel():
            t_in, p_in = self.src_t[idx], self.src_p[idx]
            center = torch.full_like(p_in, 1.0 / 3.0)
            t1, p1 = exp_map_plain(self.tm, t_in, center, p_in - center)
            self.src_t = self.src_t.index_copy(0, idx, t1)
            self.src_p = self.src_p.index_copy(0, idx, p1)

    def as_dtype(self, dtype) -> "ReferenceFlow":
        """The same mesh, basis and texel table with the floating tables in
        ``dtype`` (the control computes in float32)."""
        import copy

        other = copy.copy(self)
        other.dtype = dtype

        def cast(x):
            return x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x

        for name, value in vars(self).items():
            if torch.is_tensor(value):
                setattr(other, name, cast(value))
        other.tm = type(self.tm)(**{k: cast(v) for k, v in vars(self.tm).items()})
        other.basis = type(self.basis)(**{k: cast(v) for k, v in vars(self.basis).items()})
        return other

    # -- signals ---------------------------------------------------------

    def _smooth(self, signal, weight):
        """(M + w K)^-1 M s, warm-started from s (FlowData::smoothSignal)."""
        sys_vals = self.mass + weight * self.stiff
        b = ell_matvec(self.v_cols, self.mass, signal)
        diag = torch.gather(sys_vals, 1, self.v_diag_slot[:, None])[:, 0]
        x, _, _ = jacobi_pcg(self.v_cols, sys_vals, diag, b, x0=signal, tol=SOLVE_TOL)
        return x

    def _dog_band(self, signal):
        """Variance-renormalized difference-of-Gaussians band
        (OpticalFlow.cpp:822-854)."""
        smoothed = self._smooth(signal, self.flags["dogSmooth"])
        b = ell_matvec(self.v_cols, self.mass, signal)
        old_avg = torch.einsum("v,vc->c", self.lumped, signal)
        old_var = torch.einsum("vc,vc->c", signal, b) - old_avg * old_avg
        hi = signal - smoothed
        b_hi = ell_matvec(self.v_cols, self.mass, hi)
        new_avg = torch.einsum("v,vc->c", self.lumped, hi)
        new_var = torch.einsum("vc,vc->c", hi, b_hi) - new_avg * new_avg
        scale = torch.sqrt(old_var / torch.where(new_var > 0, new_var, torch.ones_like(new_var)))
        return (hi - new_avg[None, :]) * scale[None, :] + old_avg[None, :]

    # -- the alignment ---------------------------------------------------

    def align(self, tex0: np.ndarray, tex1: np.ndarray, store=identity) -> torch.Tensor:
        """The flow (T, 2) after every level (IterativeOptimization,
        OpticalFlow.cpp:1035-1043) for two (H, W, 3) uint8 textures."""
        f, kw = self.flags, dict(dtype=self.dtype, device=self.device)
        raw = [torch.as_tensor(bake(self.tris, self.uvs, t, self.n_vertices)).to(**kw)
               for t in (tex0, tex1)]
        if f["dogWeight"] != 1.0 or f["log"]:
            raise ValueError("the reference runs the DoG band alone (dogWeight 1, no log)")
        signals = store(self._dog_band(torch.cat(raw, dim=1)))
        c = signals.shape[1] // 2
        t_count = self.n_triangles
        tm = self.tm
        coeffs = torch.zeros(self.basis.n_coeffs, **kw)
        tfield = torch.zeros((t_count, 2), **kw)
        s_weight, v_weight = f["sSmooth"], f["vfSmooth"]
        t0 = torch.arange(t_count, device=self.device).repeat(2)
        p0 = torch.full((2 * t_count, 2), 1.0 / 3.0, **kw)
        times = torch.cat([torch.full((t_count,), -0.5, **kw),
                           torch.full((t_count,), 0.5, **kw)])
        for _ in range(int(f["iterations"])):
            smoothed = store(self._smooth(signals, s_weight))
            t1, p1, _ = flow_field_trace_compacted_plain(tm, tfield, times, t0, p0,
                                                         f["minStep"], int(f["maxSteps"]))
            sampled = sample_vertex_signal(tm.triangles, smoothed, t1, p1)
            both = torch.cat([sampled[:t_count, :c], sampled[t_count:, c:]], dim=1)
            res = vertex_mean(tm.triangles, both, self.n_vertices)
            d_blocks, rhs_t = data_term_blocks(tm.triangles, self.area, res[:, :c], res[:, c:])
            sys_vals, dt_vals, rhs, diag = flow_system(self.basis, d_blocks, rhs_t,
                                                       torch.as_tensor(v_weight, **kw))
            x, _, _ = jacobi_pcg(self.basis.ell_cols, sys_vals, diag, rhs, tol=SOLVE_TOL)
            coeffs, tfield = flow_step(self.basis, coeffs, store(x), dt_vals, rhs)
            coeffs, tfield = store(coeffs), store(tfield)
            s_weight *= f["sMultiply"]
            if v_weight * f["vMultiply"] > f["vfSThreshold"]:
                v_weight *= f["vMultiply"]
        return tfield

    def halfway(self, tfield: torch.Tensor, tex0: np.ndarray, tex1: np.ndarray,
                alpha: float, store=identity) -> np.ndarray:
        """(H, W, 3) uint8 blend of both textures advected to ``alpha``
        along ``tfield`` (OutputImage, OpticalFlow.cpp:1044-1047), rows in uv
        order (row 0 at v = 0); unclaimed texels keep the inputs' blend."""
        f, kw = self.flags, dict(dtype=self.dtype, device=self.device)
        n = self.src_t.shape[0]
        t2 = torch.cat([self.src_t, self.src_t])
        p2 = torch.cat([self.src_p, self.src_p])
        times = torch.cat([torch.full((n,), -alpha, **kw), torch.full((n,), 1.0 - alpha, **kw)])
        t1, p1, _ = flow_field_trace_compacted_plain(self.tm, tfield.to(self.dtype), times, t2,
                                                     p2, f["minStep"], int(f["maxSteps"]))
        texs = [torch.as_tensor(t).to(**kw) for t in (tex0, tex1)]
        c0 = store(_fetch_colors(self.tri_uvs, texs[0], t1[:n], p1[:n], True))
        c1 = store(_fetch_colors(self.tri_uvs, texs[1], t1[n:], p1[n:], True))
        base = (torch.flip(texs[0], [0]) + torch.flip(texs[1], [0])).reshape(-1, 3)
        accum = torch.where((self.src_t >= 0)[:, None], c0 + c1, base)
        blend = (accum / 2.0).reshape(self.height, self.width, 3)
        return torch.clamp(blend, 0, 255).to(torch.uint8).cpu().numpy()
