// Padded-ELL sparse matrix products for Hopper (sm_90a): y = A x and
// Y = A X for 1 <= C <= 8 right-hand sides.
//
// Replaces the two Pallas TPU kernels of the reference package:
//   spmv_ell_<type>(..., c = 1)   <- meshopticalflow_tpu/kernels/pallas_spmv.py:_spmv_kernel
//                                    (spmv_tiles / PallasEll.apply)
//   spmv_ell_<type>(..., c = C)   <- pallas_spmv.py:_spmv_multi_kernel
//                                    (spmv_tiles_multi / PallasEll.apply_multi)
// for value types f32 (f32 x and sums), bf16 (f32 x and sums) and f64.
//
// Layout. The operator is the padded-ELL pair the level assembles, cols
// (N, W) int32 and vals (N, W), both row-major; padding slots carry value 0
// and a real column. The TPU kernels stream 128x128 tiles of an RCM-permuted
// copy because Mosaic has no row gather; Hopper gathers x natively, so these
// kernels read the ELL arrays as they are. x is reached only through cols,
// so rectangular operators (the multigrid transfers P0 and P0^T) are the
// same product with N output rows. X and Y are (rows, C) row-major.
//
// Bound. A product does 2 flops per 6-12 streamed bytes, so on an H100
// (3.35 TB/s HBM3, 67 TFLOP/s f32 outside the tensor cores) it is bound by
// bytes: at the main path's level-0 flow operator (589,824 rows, W = 9,
// f32) the operator is 42.5 MB and x and y 2.4 MB each, 12.91 us at the HBM
// rate for its stored non-zeros as CSR. What the card actually spends goes
// to the x gathers and to how many rows an SM keeps in flight: the same
// kernel with every slot of a row reading one x element is within 1.5 us of
// the scattered gather on the flow operator, and a one-column row costs a
// thread a chain of index read, gather and multiply-add. (chip_smoke.py
// phase 7 measures every form, its bound and these diagnostics on an NVIDIA
// H100 80GB HBM3 at 700.00 W; PERF.md keeps the numbers.)
//
// Design, chosen per launch by the host's plan (kernels/spmv.py:launch_plan)
// from W and C:
//
// * Slab ring (W <= 16: the flow, smoothing, c1 and P0 operators).
//   Persistent CTAs, as many as the card holds at once, each walk slabs of
//   R consecutive rows (slab s, s + grid, ...). In row-major padded ELL a
//   slab's cols and vals are each one contiguous range, so one thread issues
//   two 1-D bulk copies (cp.async.bulk, the TMA's 1-D form) per slab into a
//   ring of `stages` shared-memory stages, each completing on its own
//   mbarrier; the CTA computes the slab that has landed while the next one
//   streams in, and no thread spends an instruction or a register on the
//   operator's stream. R is a multiple of 8, which makes every slab's offset
//   and size a multiple of 16 bytes for every value type (bf16 with odd W
//   included); the caller guarantees 16-byte aligned cols and vals. The
//   partial last slab is read from global memory directly. The ring is kept
//   small (2 stages, 128 threads, slabs of 8 KB or more): shared memory per
//   CTA sets how many CTAs, and so how many rows and gathers, an SM holds.
// * Lane groups (W > 16: P0^T, W = 40 and 49; the fallback's P12^T, W = 69).
//   G lanes per row (4 to 32) read consecutive slots of the row, so a
//   group's loads are coalesced, and a butterfly of shuffles sums the group.
//   G is chosen so that one column's slots fit one chunk of gathers per
//   lane: 36,864 rows of P0^T x 40 give 16 lanes of 3 slots each instead of
//   one thread walking 40 slots in a chain.
// * All columns of a row in one pass (both variants). C is a template
//   parameter, so the C sums stay in registers and each slot's index and
//   value are read once for the row. In the slab ring a row's C columns are
//   split over C / E lanes, each gathering one aligned vector of E columns
//   (C = 6 in f32: three lanes of a float2) and writing it once: together
//   they read x's row as whole vectors and write y's row once, and a warp's
//   gather touches 32 / (C / E) rows. In a lane group each lane gathers the
//   whole C-wide row of each of its slots in such vectors.
//
// Gathers go in chunks of 4 slots, all issued before their multiply-adds: a
// longer chunk costs registers, and the rows an SM holds, for no gain.
//
// Sums accumulate in f32 for f32 and bf16 values and in f64 for f64. The slab
// variant sums each output over its slots in slot order; the lane groups sum
// slot k into lane k mod G and then across the group.
//
// Each launch entry runs on the given stream and returns cudaGetLastError(),
// which the Python wrapper raises on. A bulk copy that never lands traps
// (a launch error) instead of spinning forever.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxStages = 8;
constexpr int kSlab = 0;
constexpr int kGroup = 1;

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

__device__ __forceinline__ float madd(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double madd(double a, double b, double c) { return fma(a, b, c); }

// The vector access of a C-wide row of T: the widest of 16, 8 or sizeof(T)
// bytes that divides the row. The wrapper checks x's alignment against it
// (kernels/spmv.py:vector_bytes). In the slab variant kLanes lanes share a
// row, each taking one vector of its C columns.
template <typename T, int C>
struct RowVec {
  static constexpr int kBytes = (C * sizeof(T)) % 16 == 0 ? 16
                              : (C * sizeof(T)) % 8 == 0 ? 8 : static_cast<int>(sizeof(T));
  static constexpr int kElems = kBytes / static_cast<int>(sizeof(T));
  static constexpr int kLanes = C / kElems;
};

template <typename T, int E> struct Vec;
template <> struct Vec<float, 1> { using type = float; };
template <> struct Vec<float, 2> { using type = float2; };
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<double, 1> { using type = double; };
template <> struct Vec<double, 2> { using type = double2; };

template <typename T> __device__ __forceinline__ void unpack(T v, T* o) { o[0] = v; }
__device__ __forceinline__ void unpack(float2 v, float* o) { o[0] = v.x; o[1] = v.y; }
__device__ __forceinline__ void unpack(float4 v, float* o) { o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w; }
__device__ __forceinline__ void unpack(double2 v, double* o) { o[0] = v.x; o[1] = v.y; }

template <typename T, int E> __device__ __forceinline__ typename Vec<T, E>::type pack(const T* a);
template <> __device__ __forceinline__ float pack<float, 1>(const float* a) { return a[0]; }
template <> __device__ __forceinline__ float2 pack<float, 2>(const float* a) { return make_float2(a[0], a[1]); }
template <> __device__ __forceinline__ float4 pack<float, 4>(const float* a) {
  return make_float4(a[0], a[1], a[2], a[3]);
}
template <> __device__ __forceinline__ double pack<double, 1>(const double* a) { return a[0]; }
template <> __device__ __forceinline__ double2 pack<double, 2>(const double* a) {
  return make_double2(a[0], a[1]);
}

// N elements of T at p through the read-only path, in vectors of E.
template <typename T, int N, int E>
__device__ __forceinline__ void load_elems(const T* __restrict__ p, T (&out)[N]) {
#pragma unroll
  for (int j = 0; j < N; j += E) {
    unpack(__ldg(reinterpret_cast<const typename Vec<T, E>::type*>(p + j)), out + j);
  }
}

template <typename T, int N, int E>
__device__ __forceinline__ void store_elems(T* __restrict__ p, const T (&acc)[N]) {
#pragma unroll
  for (int j = 0; j < N; j += E) {
    *reinterpret_cast<typename Vec<T, E>::type*>(p + j) = pack<T, E>(acc + j);
  }
}

// acc += the row's slots k_begin, k_begin + k_step, ... below w, for the N
// columns of X (N_in, C) that start at x_piece (c, v: the row's indices and
// values, in shared memory for a landed slab or in global memory); each
// output sums in slot order, in chunks of kChunk slots.
template <typename V, typename T, int C, int N>
__device__ __forceinline__ void slot_sum(const int32_t* c, const V* v,
                                         const T* __restrict__ x_piece, int k_begin,
                                         int k_step, int w, T (&acc)[N]) {
  constexpr int kChunk = 4;
  constexpr int kVec = RowVec<T, C>::kElems;
  for (int k0 = k_begin; k0 < w; k0 += kChunk * k_step) {
    T xs[kChunk][N];
    T vs[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int kk = k0 + k * k_step;
      if (kk < w) {
        load_elems<T, N, kVec>(x_piece + static_cast<int64_t>(c[kk]) * C, xs[k]);
        vs[k] = widen<V, T>(v[kk]);
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (k0 + k * k_step < w) {
#pragma unroll
        for (int j = 0; j < N; ++j) acc[j] = madd(vs[k], xs[k][j], acc[j]);
      }
    }
  }
}

// One vector piece (kElems columns) of an output row, over all its slots.
template <typename V, typename T, int C>
__device__ __forceinline__ void row_piece(const int32_t* c, const V* v,
                                          const T* __restrict__ x, T* __restrict__ y,
                                          int64_t row, int piece, int w) {
  constexpr int kVec = RowVec<T, C>::kElems;
  T acc[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[j] = T(0);
  slot_sum<V, T, C, kVec>(c, v, x + piece * kVec, 0, 1, w, acc);
  store_elems<T, kVec, kVec>(y + row * C + piece * kVec, acc);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spin = 0; !done; ++spin) {
    if (spin == (1u << 24)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// Two bulk copies (a slab's cols, then its vals) into one stage, completing
// on the stage's barrier. Issued by one thread.
__device__ __forceinline__ void issue_slab(uint32_t bar, uint32_t dst, const void* cols_src,
                                           uint32_t cols_bytes, const void* vals_src,
                                           uint32_t vals_bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(cols_bytes + vals_bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(cols_src), "r"(cols_bytes), "r"(bar) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(dst + cols_bytes), "l"(vals_src), "r"(vals_bytes), "r"(bar) : "memory");
}

// Persistent slab ring: CTA b computes slabs b, b + grid, ... of `rows` rows
// each; `stages` shared-memory stages of rows * w * (4 + sizeof(V)) bytes.
template <typename V, typename T, int C>
__global__ void spmv_slab_kernel(const int32_t* __restrict__ cols,
                                 const V* __restrict__ vals,
                                 const T* __restrict__ x, T* __restrict__ y,
                                 int64_t n, int w, int rows, int stages) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  const int64_t slab_elems = static_cast<int64_t>(rows) * w;
  const uint32_t cols_bytes = static_cast<uint32_t>(slab_elems * 4);
  const uint32_t vals_bytes = static_cast<uint32_t>(slab_elems * sizeof(V));
  const uint32_t stage_bytes = cols_bytes + vals_bytes;
  const int64_t n_full = n / rows;
  const int64_t n_slabs = (n + rows - 1) / rows;
  const uint32_t ring_addr = smem_addr(ring);
  // kLanes lanes per row, one vector piece each; leftover threads idle.
  constexpr int kLanes = RowVec<T, C>::kLanes;
  const int first = threadIdx.x / kLanes;
  const int piece = threadIdx.x % kLanes;
  const int row_step = blockDim.x / kLanes;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   :: "r"(smem_addr(&full[s])), "r"(1) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      const int64_t slab = blockIdx.x + static_cast<int64_t>(s) * gridDim.x;
      if (slab < n_full) {
        issue_slab(smem_addr(&full[s]), ring_addr + s * stage_bytes,
                   cols + slab * slab_elems, cols_bytes, vals + slab * slab_elems, vals_bytes);
      }
    }
  }

  int it = 0;
  for (int64_t slab = blockIdx.x; slab < n_slabs; slab += gridDim.x, ++it) {
    const int stage = it % stages;
    const int64_t row0 = slab * rows;
    if (slab < n_full) {
      wait_parity(smem_addr(&full[stage]), static_cast<uint32_t>(it / stages) & 1u);
      const int32_t* sc = reinterpret_cast<const int32_t*>(ring + stage * stage_bytes);
      const V* sv = reinterpret_cast<const V*>(ring + stage * stage_bytes + cols_bytes);
      if (first < row_step) {
        for (int r = first; r < rows; r += row_step) {
          row_piece<V, T, C>(sc + r * w, sv + r * w, x, y, row0 + r, piece, w);
        }
      }
      __syncthreads();   // every thread is done with this stage
      if (threadIdx.x == 0) {
        const int64_t next = slab + static_cast<int64_t>(stages) * gridDim.x;
        if (next < n_full) {
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          issue_slab(smem_addr(&full[stage]), ring_addr + stage * stage_bytes,
                     cols + next * slab_elems, cols_bytes, vals + next * slab_elems, vals_bytes);
        }
      }
    } else if (first < row_step) {
      for (int64_t r = row0 + first; r < n; r += row_step) {
        row_piece<V, T, C>(cols + r * w, vals + r * w, x, y, r, piece, w);
      }
    }
  }
}

// `group` lanes per row (a power of two up to 32): lane l sums slots l,
// l + group, ...; a butterfly of shuffles inside the group adds the lanes'
// sums. Persistent: CTA b takes the row blocks b, b + grid, ... of
// blockDim / group rows; the block loop is uniform across the CTA, so every
// lane of a warp reaches every shuffle.
template <typename V, typename T, int C>
__global__ void spmv_group_kernel(const int32_t* __restrict__ cols,
                                  const V* __restrict__ vals,
                                  const T* __restrict__ x, T* __restrict__ y,
                                  int64_t n, int w, int group) {
  const int shift = __ffs(group) - 1;
  const int lane = threadIdx.x & (group - 1);
  const int64_t rows_per_cta = blockDim.x >> shift;
  for (int64_t base = blockIdx.x * rows_per_cta; base < n; base += gridDim.x * rows_per_cta) {
    const int64_t row = base + (threadIdx.x >> shift);
    T acc[C];
#pragma unroll
    for (int j = 0; j < C; ++j) acc[j] = T(0);
    if (row < n) slot_sum<V, T, C, C>(cols + row * w, vals + row * w, x, lane, group, w, acc);
    for (int off = group >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int j = 0; j < C; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off, group);
    }
    if (row < n && lane == 0) store_elems<T, C, RowVec<T, C>::kElems>(y + row * C, acc);
  }
}

// Dynamic shared memory above 48 KB must be allowed per kernel and device
// before a launch or an occupancy query asks for it; `allowed` is per
// instantiation and records the current device's grant.
template <typename V, typename T, int C>
int allow_slab_smem(int smem) {
  constexpr int kDevices = 64;
  static int allowed[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kDevices || smem > allowed[dev]) {
    err = cudaFuncSetAttribute(
        spmv_slab_kernel<V, T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kDevices) allowed[dev] = smem;
  }
  return 0;
}

template <typename V, typename T, int C>
int launch(const void* cols, const void* vals, const void* x, void* y, int64_t n,
           int w, int variant, int threads, int rows_or_group, int stages,
           int smem, int grid, cudaStream_t stream) {
  const auto* c = static_cast<const int32_t*>(cols);
  const auto* v = static_cast<const V*>(vals);
  const auto* xx = static_cast<const T*>(x);
  auto* yy = static_cast<T*>(y);
  if (variant == kSlab) {
    const int64_t ring = static_cast<int64_t>(stages) * rows_or_group * w * (4 + sizeof(V));
    if (stages < 1 || stages > kMaxStages || rows_or_group < 8 || rows_or_group % 8 != 0 ||
        ring > smem) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    int err = allow_slab_smem<V, T, C>(smem);
    if (err) return err;
    spmv_slab_kernel<V, T, C><<<grid, threads, smem, stream>>>(
        c, v, xx, yy, n, w, rows_or_group, stages);
  } else if (variant == kGroup) {
    if (rows_or_group < 1 || rows_or_group > 32 || (rows_or_group & (rows_or_group - 1)) ||
        threads % rows_or_group != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    spmv_group_kernel<V, T, C><<<grid, threads, 0, stream>>>(c, v, xx, yy, n, w, rows_or_group);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename V, typename T, int C>
int occupancy(int variant, int threads, int smem, int* ctas_per_sm) {
  cudaError_t err;
  if (variant == kSlab) {
    int e = allow_slab_smem<V, T, C>(smem);
    if (e) return e;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas_per_sm, spmv_slab_kernel<V, T, C>, threads, smem);
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas_per_sm, spmv_group_kernel<V, T, C>, threads, smem);
  }
  return static_cast<int>(err);
}

#define SPMV_FOR_EACH_C(FN, V, T, ...)                                  \
  switch (c) {                                                          \
    case 1: return FN<V, T, 1>(__VA_ARGS__);                            \
    case 2: return FN<V, T, 2>(__VA_ARGS__);                            \
    case 3: return FN<V, T, 3>(__VA_ARGS__);                            \
    case 4: return FN<V, T, 4>(__VA_ARGS__);                            \
    case 5: return FN<V, T, 5>(__VA_ARGS__);                            \
    case 6: return FN<V, T, 6>(__VA_ARGS__);                            \
    case 7: return FN<V, T, 7>(__VA_ARGS__);                            \
    case 8: return FN<V, T, 8>(__VA_ARGS__);                            \
    default: return static_cast<int>(cudaErrorInvalidValue);            \
  }

}  // namespace

// Entry points, one pair per value type. c = 1 is the single-vector product
// (x (N_in,) has the layout of X (N_in, 1)). The launch plan (variant,
// threads, rows per slab or lanes per row, stages, shared memory, grid)
// comes from kernels/spmv.py:launch_plan.
#define SPMV_ENTRIES(TAG, V, T)                                                  \
  extern "C" int spmv_ell_##TAG(const void* cols, const void* vals, const void* x, \
                                void* y, int64_t n, int w, int c, int variant,    \
                                int threads, int rows_or_group, int stages,      \
                                int smem, int grid, void* stream) {              \
    SPMV_FOR_EACH_C(launch, V, T, cols, vals, x, y, n, w, variant, threads,      \
                    rows_or_group, stages, smem, grid,                           \
                    static_cast<cudaStream_t>(stream))                           \
  }                                                                              \
  extern "C" int spmv_ell_occupancy_##TAG(int c, int variant, int threads,       \
                                          int smem, int* ctas_per_sm) {          \
    SPMV_FOR_EACH_C(occupancy, V, T, variant, threads, smem, ctas_per_sm)        \
  }

SPMV_ENTRIES(f32, float, float)
SPMV_ENTRIES(bf16, __nv_bfloat16, float)
SPMV_ENTRIES(f64, double, double)
