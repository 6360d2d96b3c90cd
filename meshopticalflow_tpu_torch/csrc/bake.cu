// The per-vertex texture bake for Hopper (sm_90a):
//
//   bake_vertices_f64  <- flow/pipeline.py:sample_texture_to_vertices, run
//                         once a texture on the host (a float64 copy of the
//                         atlas, four bilinear gathers over the wedges, two
//                         np.add.at): the vertex colours that
//                         FlowProblem.from_texture_inputs aligns
//
// It replaces no TPU kernel: the reference package bakes on the host too
// (meshopticalflow_tpu/flow/pipeline.py:sample_texture_to_vertices). It was
// added because the host bake paced a pair of the --serve worker's path
// (about 1.4 s of a 2.5 s pair at 393,216 triangles and 2048^2, the card
// idle through it).
//
// Bound: bytes. Each wedge's uv is read once (16 bytes), its id once (4)
// and each vertex's two offsets once (4); each vertex writes 2 x 3 doubles;
// the two atlases are read where the taps land (at most the whole of both,
// 3 bytes a texel). About 60 MB a pair at the main path's 1,179,648 wedges,
// 196,610 vertices and 2048^2, some 18 µs at 3.35 TB/s. The taps are
// gathers of single bytes and the uvs gathers of 16 bytes, so the kernel
// sits well above that.
//
// Design: one thread a vertex. It walks its wedges in ascending wedge index
// (the per-mesh table kernels/bake.py:wedge_table: wedge ids sorted by
// vertex with a stable sort, and each vertex's offset into them), forms each
// wedge's bilinear (or nearest) sample of both textures, and sums them in
// float64 from 0.0 in that order: the order in which np.add.at adds. No
// atomics, so one launch gives the same bits every time. Every sample is
// _host_sample_texture's expression in its order of operations, and the
// library is built with -fmad=false (kernels/bake.py: LIBRARY), so that no
// a * b + c is contracted into one rounding that numpy's separate
// elementwise passes do not make; double division is IEEE. The result equals
// the host copy's bit for bit.
//
// The entry point launches on the given stream and returns
// cudaGetLastError(), which the Python wrapper checks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTextures = 2;    // one launch bakes both textures of a pair

__device__ __forceinline__ double clip01(double a) {
  // np.clip(a, 0, 1) as np.minimum(np.maximum(a, 0), 1)
  return a < 0.0 ? 0.0 : (a > 1.0 ? 1.0 : a);
}

__global__ void __launch_bounds__(kThreads)
bake_kernel(const uint8_t* __restrict__ tex, const double2* __restrict__ uvs,
            const int32_t* __restrict__ wedges, const int32_t* __restrict__ offsets,
            int64_t n_vertices, int64_t h, int64_t w, bool bilinear,
            double* __restrict__ out) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= n_vertices) return;
  const int32_t begin = __ldg(offsets + v), end = __ldg(offsets + v + 1);
  const int64_t plane = h * w * 3;
  const double wm1 = static_cast<double>(w - 1), hm1 = static_cast<double>(h - 1);
  double acc[kTextures][3];
#pragma unroll
  for (int s = 0; s < kTextures; ++s) {
    acc[s][0] = 0.0;
    acc[s][1] = 0.0;
    acc[s][2] = 0.0;
  }
  for (int32_t k = begin; k < end; ++k) {
    const double2 uv = __ldg(uvs + __ldg(wedges + k));
    const double x = clip01(uv.x) * wm1;
    const double y = clip01(1.0 - uv.y) * hm1;
    const double fx0 = floor(x), fy0 = floor(y);
    const int64_t x0 = static_cast<int64_t>(fx0), y0 = static_cast<int64_t>(fy0);
    const int64_t t00 = (y0 * w + x0) * 3;
    if (!bilinear) {
#pragma unroll
      for (int s = 0; s < kTextures; ++s) {
        const uint8_t* t = tex + s * plane;
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[s][c] = acc[s][c] + static_cast<double>(__ldg(t + t00 + c));
      }
      continue;
    }
    const int64_t x1 = x0 + 1 < w - 1 ? x0 + 1 : w - 1;
    const int64_t y1 = y0 + 1 < h - 1 ? y0 + 1 : h - 1;
    const int64_t t01 = (y0 * w + x1) * 3, t11 = (y1 * w + x1) * 3, t10 = (y1 * w + x0) * 3;
    const double dx = x - fx0, dy = y - fy0;
    const double odx = 1.0 - dx, ody = 1.0 - dy;
#pragma unroll
    for (int s = 0; s < kTextures; ++s) {
      const uint8_t* t = tex + s * plane;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const double a = static_cast<double>(__ldg(t + t00 + c)) * odx * ody;
        const double b = static_cast<double>(__ldg(t + t01 + c)) * dx * ody;
        const double d = static_cast<double>(__ldg(t + t11 + c)) * dx * dy;
        const double e = static_cast<double>(__ldg(t + t10 + c)) * odx * dy;
        acc[s][c] = acc[s][c] + (((a + b) + d) + e);
      }
    }
  }
  const int32_t count = end - begin;
  const double denom = static_cast<double>(count > 1 ? count : 1);
#pragma unroll
  for (int s = 0; s < kTextures; ++s) {
    double* o = out + (s * n_vertices + v) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) o[c] = acc[s][c] / denom;
  }
}

}  // namespace

extern "C" {

int bake_vertices_f64(const void* tex, const void* uvs, const void* wedges, const void* offsets,
                      int64_t n_vertices, int64_t h, int64_t w, int bilinear, void* out,
                      void* stream) {
  if (n_vertices > 0) {
    bake_kernel<<<static_cast<unsigned>((n_vertices + kThreads - 1) / kThreads), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(tex), static_cast<const double2*>(uvs),
        static_cast<const int32_t*>(wedges), static_cast<const int32_t*>(offsets), n_vertices,
        h, w, bilinear != 0, static_cast<double*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
