"""The per-vertex texture bake: the kernel of csrc/bake.cu and its plain
PyTorch twin.

The vertex colours of a texture pair are each vertex's average of its
wedges' texture samples (MeshFlow.inl:251-266), which the host copy
flow/pipeline.py:sample_texture_to_vertices computes with numpy, one texture
at a time. Here:

  * ``wedge_table(triangles, n_vertices, device)``: the per-mesh table the
    bake walks: the wedge ids (int32, 3T) sorted by vertex with a stable
    sort, so each vertex's wedges stand in ascending wedge index, the order
    in which ``np.add.at`` adds them, and each vertex's offset into them
    (int32, V + 1);
  * ``bake_vertices(textures, uvs, wedges, offsets, bilinear)``: both
    textures of a pair, (2, H, W, 3) uint8, sampled at the wedge uvs (3T, 2)
    float64 (bilinear, or the nearest texel) and averaged a vertex, in
    float64: (2, V, 3).

On CUDA tensors ``bake_vertices`` is one launch of bake_vertices_f64 (or an
error raised: no fallback); on CPU tensors it runs the twin
``bake_vertices_plain``, which repeats the host copy's arithmetic op for op
and sums each vertex's wedges in the table's order with a Python loop over
the padded degree, so both equal the host copy bit for bit. Each launch
counts into utils/spans.py's counter table under ``launch.bake_vertices``,
which ``bake_vertices.launches`` reads; the twin counts the calls it gets
with CUDA tensors in ``bake_vertices_plain.cuda_calls``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from meshopticalflow_tpu_torch.kernels.build import (
    NVCC_FLAGS, CudaLibrary, raise_on, stream_of)
from meshopticalflow_tpu_torch.utils import spans

TEXTURES = 2    # a launch bakes both textures of a pair


def wedge_table(triangles, n_vertices: int, device="cpu"):
    """(wedges, offsets) of a mesh on ``device``: the wedge ids t * 3 + k of
    ``triangles`` (T, 3) in a stable sort by vertex, and each vertex's first
    position in them, with the wedge count at the end (int32 both)."""
    corners = np.asarray(triangles).reshape(-1)
    if corners.size >= 2 ** 31:
        raise ValueError(f"wedge table: {corners.size} wedges; the bake indexes them as "
                         f"int32 (3T < 2^31)")
    counts = np.bincount(corners, minlength=n_vertices)
    if counts.size > n_vertices:
        raise ValueError(f"wedge table: vertex {counts.size - 1} of {n_vertices} vertices")
    offsets = np.zeros(n_vertices + 1, np.int32)
    np.cumsum(counts, out=offsets[1:])
    wedges = np.argsort(corners, kind="stable").astype(np.int32)
    return torch.from_numpy(wedges).to(device), torch.from_numpy(offsets).to(device)


# -- the plain twin -------------------------------------------------------------

def _samples(textures: torch.Tensor, uv: torch.Tensor, bilinear: bool) -> torch.Tensor:
    """Each texture's sample at the uvs (N, 2): (S, N, 3) float64, in the
    host copy's order of operations (flow/pipeline.py:_host_sample_texture)."""
    h, w = textures.shape[1:3]
    x = uv[:, 0].clamp(0, 1) * (w - 1)
    y = (1.0 - uv[:, 1]).clamp(0, 1) * (h - 1)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()

    def tap(yy, xx):
        return textures[:, yy, xx].to(torch.float64)

    if not bilinear:
        return tap(y0, x0)
    x1 = (x0 + 1).clamp(max=w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    dx, dy = (x - x0)[:, None], (y - y0)[:, None]
    return (tap(y0, x0) * (1 - dx) * (1 - dy) + tap(y0, x1) * dx * (1 - dy)
            + tap(y1, x1) * dx * dy + tap(y1, x0) * (1 - dx) * dy)


def bake_vertices_plain(textures: torch.Tensor, uvs: torch.Tensor, wedges: torch.Tensor,
                        offsets: torch.Tensor, bilinear: bool = True) -> torch.Tensor:
    """The vertex colours (S, V, 3) float64 of ``textures`` (S, H, W, 3)
    uint8 at the wedge ``uvs`` (3T, 2) float64: each vertex's samples summed
    from 0.0 in its wedges' order in the table, over its wedge count (at
    least 1)."""
    if textures.is_cuda:
        bake_vertices_plain.cuda_calls += 1
    samples = _samples(textures, uvs.reshape(-1, 2)[wedges.long()], bilinear)
    counts = offsets[1:] - offsets[:-1]
    start = offsets[:-1].long()
    out = torch.zeros((textures.shape[0], counts.shape[0], 3), dtype=torch.float64,
                      device=textures.device)
    for k in range(int(counts.max()) if counts.numel() else 0):
        live = counts > k
        slot = torch.where(live, start + k, 0)
        out = out + torch.where(live[:, None], samples[:, slot], 0.0)
    return out / counts.clamp(min=1).to(torch.float64)[:, None]


bake_vertices_plain.cuda_calls = 0


# -- the CUDA kernel (csrc/bake.cu) ---------------------------------------------

def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.bake_vertices_f64.argtypes = [p, p, p, p, i64, i64, i64, i32, p, p]
    lib.bake_vertices_f64.restype = ctypes.c_int
    return lib


# -fmad=false: no a * b + c contracted into one rounding, as the host copy's
# separate numpy passes round each product and sum.
LIBRARY = CudaLibrary("bake", "bake.cu", _bind, flags=NVCC_FLAGS + ("-fmad=false",))


def _check(textures, uvs, wedges, offsets) -> None:
    name = "bake_vertices"
    if textures.dtype != torch.uint8 or uvs.dtype != torch.float64 \
            or wedges.dtype != torch.int32 or offsets.dtype != torch.int32:
        raise TypeError(f"{name}: textures uint8, uvs float64, wedges and offsets int32 "
                        f"expected, got {textures.dtype}, {uvs.dtype}, {wedges.dtype}, "
                        f"{offsets.dtype}")
    if textures.dim() != 4 or textures.shape[0] != TEXTURES or textures.shape[3] != 3:
        raise ValueError(f"{name}: textures of {tuple(textures.shape)}, "
                         f"({TEXTURES}, H, W, 3) expected")
    if uvs.shape[-1] != 2 or uvs.numel() != 2 * wedges.numel() \
            or wedges.dim() != 1 or offsets.dim() != 1 or offsets.numel() < 1:
        raise ValueError(f"{name}: uvs of {tuple(uvs.shape)} for {wedges.numel()} wedges and "
                         f"offsets of {tuple(offsets.shape)}")
    devices = {t.device for t in (textures, uvs, wedges, offsets)}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on different devices "
                         f"({sorted(str(d) for d in devices)})")


@spans.launches("launch.bake_vertices")
def bake_vertices(textures: torch.Tensor, uvs: torch.Tensor, wedges: torch.Tensor,
                  offsets: torch.Tensor, bilinear: bool = True) -> torch.Tensor:
    """Both textures' vertex colours (2, V, 3) float64; ``wedges`` and
    ``offsets`` from ``wedge_table``. CPU tensors: the plain twin. CUDA
    tensors: one launch of bake_vertices_f64, or an error."""
    _check(textures, uvs, wedges, offsets)
    dev = textures.device
    if dev.type == "cpu":
        return bake_vertices_plain(textures, uvs, wedges, offsets, bilinear)
    if dev.type != "cuda":
        raise ValueError(f"bake_vertices: the kernel runs on CUDA tensors, got {dev}")
    textures, wedges, offsets = (t.contiguous() for t in (textures, wedges, offsets))
    uvs = uvs.reshape(-1, 2).contiguous()
    if uvs.data_ptr() % 16:        # the kernel loads a uv as one double2
        uvs = uvs.clone()
    n_vertices = offsets.numel() - 1
    h, w = textures.shape[1:3]
    out = torch.empty((TEXTURES, n_vertices, 3), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        err = LIBRARY.load().bake_vertices_f64(
            textures.data_ptr(), uvs.data_ptr(), wedges.data_ptr(), offsets.data_ptr(),
            n_vertices, h, w, int(bilinear), out.data_ptr(), stream_of(dev))
    raise_on(err, "bake_vertices")
    spans.count("launch.bake_vertices")
    return out


def reset_counts() -> None:
    """Zero the launch count and the twin's calls on CUDA tensors."""
    spans.clear("launch.bake_vertices")
    bake_vertices_plain.cuda_calls = 0
