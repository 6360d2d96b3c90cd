// Padded-ELL sparse matrix-vector products for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the reference package:
//   spmv_ell        <- meshopticalflow_tpu/kernels/pallas_spmv.py:_spmv_kernel
//                      (reached through spmv_tiles / PallasEll.apply)
//   spmv_ell_multi  <- meshopticalflow_tpu/kernels/pallas_spmv.py:_spmv_multi_kernel
//                      (reached through spmv_tiles_multi / PallasEll.apply_multi)
//
// Layout. The operator is the padded-ELL pair the level assembles:
// cols (N, W) int32 and vals (N, W), both row-major. Padding slots carry
// value 0 and a real column, so no sentinel is needed. The TPU kernels
// work on 128x128 block-ELL tiles of an RCM-permuted copy, a workaround
// for Mosaic's missing row gather; Hopper gathers x natively, so these
// kernels read the ELL arrays as they are and the per-level revalue step
// is the identity.
//
// Bound. Both products do 2 flops per 8-12 streamed bytes: they are bound
// by the bytes streamed from device memory. At the main path's level-0
// flow operator (N = 589,824 Whitney unknowns, W = 9) one f32 product
// streams N*W*(4 B value + 4 B index) = 42.5 MB of operator plus x and y
// (2.4 MB each, x stays in the 50 MB L2); the TPU kernel's layout of the
// same operator (RCM order, 3 K-buckets) holds 44,952 f32 128x128 tiles,
// 2.95 GB per product. For the 6-column smoothing operator (N = 196,610,
// W = 9) the counts are 14.2 MB against 0.91 GB.
//
// Design. One thread per row (per (row, column) for the multi-rhs form):
// the 32 rows of a warp read W*32 consecutive values and indices, so each
// warp's loads cover a few contiguous cache lines; x is gathered through
// the read-only cache. Accumulation is in f32 for f32 and bf16 values and
// in f64 for f64 values, summing the W slots in order.
//
// Each entry point launches on the given stream and returns
// cudaGetLastError(), which the Python wrapper checks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

template <typename V>
__device__ __forceinline__ float to_f32(V v) { return static_cast<float>(v); }

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename V, typename T>
__device__ __forceinline__ T widen(V v) { return static_cast<T>(to_f32(v)); }

template <>
__device__ __forceinline__ double widen<double, double>(double v) { return v; }

// y[i] = sum_w vals[i, w] * x[cols[i, w]]
template <typename V, typename T>
__global__ void spmv_ell_kernel(const int32_t* __restrict__ cols,
                                const V* __restrict__ vals,
                                const T* __restrict__ x, T* __restrict__ y,
                                int64_t n, int w) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t* c = cols + i * w;
  const V* v = vals + i * w;
  T acc = T(0);
  for (int k = 0; k < w; ++k) {
    acc += widen<V, T>(v[k]) * __ldg(x + c[k]);
  }
  y[i] = acc;
}

// Y[i, j] = sum_w vals[i, w] * X[cols[i, w], j] for X, Y (N, C) row-major.
template <typename V, typename T>
__global__ void spmv_ell_multi_kernel(const int32_t* __restrict__ cols,
                                      const V* __restrict__ vals,
                                      const T* __restrict__ x,
                                      T* __restrict__ y, int64_t n, int w,
                                      int c) {
  int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n * c) return;
  int64_t i = t / c;
  int j = static_cast<int>(t - i * c);
  const int32_t* cr = cols + i * w;
  const V* v = vals + i * w;
  T acc = T(0);
  for (int k = 0; k < w; ++k) {
    acc += widen<V, T>(v[k]) * __ldg(x + static_cast<int64_t>(cr[k]) * c + j);
  }
  y[t] = acc;
}

constexpr int kThreads = 256;

template <typename V, typename T>
int launch(const void* cols, const void* vals, const void* x, void* y,
           int64_t n, int w, void* stream) {
  if (n > 0) {
    int64_t blocks = (n + kThreads - 1) / kThreads;
    spmv_ell_kernel<V, T><<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(cols), static_cast<const V*>(vals),
        static_cast<const T*>(x), static_cast<T*>(y), n, w);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename V, typename T>
int launch_multi(const void* cols, const void* vals, const void* x, void* y,
                 int64_t n, int w, int c, void* stream) {
  if (n > 0) {
    int64_t blocks = (n * c + kThreads - 1) / kThreads;
    spmv_ell_multi_kernel<V, T><<<static_cast<unsigned>(blocks), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(cols), static_cast<const V*>(vals),
        static_cast<const T*>(x), static_cast<T*>(y), n, w, c);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int spmv_ell_f32(const void* cols, const void* vals, const void* x, void* y,
                 int64_t n, int w, void* stream) {
  return launch<float, float>(cols, vals, x, y, n, w, stream);
}

int spmv_ell_bf16(const void* cols, const void* vals, const void* x, void* y,
                  int64_t n, int w, void* stream) {
  return launch<__nv_bfloat16, float>(cols, vals, x, y, n, w, stream);
}

int spmv_ell_f64(const void* cols, const void* vals, const void* x, void* y,
                 int64_t n, int w, void* stream) {
  return launch<double, double>(cols, vals, x, y, n, w, stream);
}

int spmv_ell_multi_f32(const void* cols, const void* vals, const void* x,
                       void* y, int64_t n, int w, int c, void* stream) {
  return launch_multi<float, float>(cols, vals, x, y, n, w, c, stream);
}

int spmv_ell_multi_bf16(const void* cols, const void* vals, const void* x,
                        void* y, int64_t n, int w, int c, void* stream) {
  return launch_multi<__nv_bfloat16, float>(cols, vals, x, y, n, w, c, stream);
}

int spmv_ell_multi_f64(const void* cols, const void* vals, const void* x,
                       void* y, int64_t n, int w, int c, void* stream) {
  return launch_multi<double, double>(cols, vals, x, y, n, w, c, stream);
}

}  // extern "C"
