// Capability probes for Hopper (sm_90a): one small kernel per capability
// that the reference package's Mosaic probes tested on the TPU
// (scripts/probe_pallas.py). Each is the Hopper counterpart of its probe,
// not a block-by-block copy:
//
//   probe_scale         <- p_basic (:30)                   elementwise o = 2 x
//   probe_row_gather    <- p_take_along_axis_rows (:40, call :48)  o[i,j] = x[idx[i,j], j]
//   probe_flat_gather   <- p_flat_gather (:58)              o = x[idx]
//   probe_lane_gather   <- p_dynamic_gather_lanes (:74)     o[i,j] = x[i, idx[i,j]]
//   probe_block_select  <- p_scalar_prefetch_indexmap (:89, call :103)
//                          out block b = x block sel[b] + 1
//   probe_accumulate    <- p_accumulate_grid (:110, call :121)  o[b] = sum_k x[b, k]
//   probe_bulk_copy     <- p_dma_hbm_to_vmem (:130, call :142)  rows of x through a 1-D
//                          bulk asynchronous copy global -> shared
//
// Bound: every probe moves a few KB to 512 KB at the reference script's
// shapes and does at most one add per element, so each is bound by its
// bytes, and at those sizes by its launch.
//
// probe_block_select: the index map that drives the TPU probe's block DMA
// becomes a block that loads its own index (Hopper has no scalar
// prefetch): each CTA step covers one tile of a selected block and its
// warps read sel[b] with one uniform load per tile, not one per element.
// Bound: the launch at the script's 4 blocks of 64 KB, the bytes (the
// selected blocks read once, the output written once) at large sizes.
// Design: the TPU's one grid step per block was one CTA per block here (4
// of 132 SMs busy at the script's shape, a scalar loop, latency-bound);
// now kernels/probes.py:block_select_plan cuts every block into tiles of
// threads x VPT units, with fewer threads a CTA and fewer units a thread
// while the grid would cover fewer CTAs than the card has SMs (256 CTAs of
// 32 threads x 2 float4 at the script's shape), and walks a large
// selection with a capped grid-stride grid. A thread issues all VPT 16-byte
// loads before its first add and store (one round of latency), neighbouring
// threads on neighbouring addresses. A scalar form (one float a unit) takes
// a block of floats not a multiple of 4 or operands not 16-byte aligned.
// The literal counterpart of a DMA driven by an index map, each tile
// staged through shared memory by a TMA bulk load and store, ran no faster
// on an H100 at either size for the same number of CTAs (probe_sweep.py,
// "select_tma"), so the threads move the data themselves.
//
// probe_row_gather: one thread per 16-byte output vector (row i, lanes
// j .. j+3) in the vector form: one int4 load of idx[i, j:j+4], then one
// float4 load of x[r, j:j+4] where the four indices name one row r (the
// script's broadcast index), four 4-byte loads where they do not. Bound: the
// launch at the script's (64,128) output, the bytes (the rows the indices
// name, idx and o once each) at large sizes. Design: the lane comes from
// one 64-bit division per unit, not per float; every index load of a
// thread is issued, then every x load, then the stores; the grid is spread
// and capped as block select's (kernels/probes.py:row_gather_plan). A
// scalar form takes W not a multiple of 4 or operands not 16-byte aligned.
//
// probe_accumulate: the sum over the revisited grid axis of the TPU probe,
// taken in the fixed order k = 0 .. K-1 by one thread per output element,
// no atomics. Bound: the launch at the script's (4,3,8,128) (1,024 output
// vectors, 48 KB read), the bytes (x read once, o written once) at large
// shapes. Design: one thread per 16-byte output vector (float4), so
// neighbouring threads touch neighbouring addresses; every one of a
// thread's K loads is issued before its first add (K a template parameter
// up to 8, batches of 8 above that), so the loads cost one round of
// latency, not K; small grids are spread over many SMs in CTAs of few
// threads, large ones walked by a grid-stride loop. A scalar form (one
// float a thread) takes R*W not a multiple of 4 or an operand that is not
// 16-byte aligned. kernels/probes.py:accumulate_plan picks form and grid.
//
// probe_bulk_copy: the counterpart of make_async_copy plus a DMA semaphore,
// a 1-D cp.async.bulk (the TMA's 1-D form) global -> shared completing on
// an mbarrier armed with expect_tx. Bound: the launch at the script's 64 KB,
// the bytes (read once, written once) at large sizes. Design: the write-back
// goes through the TMA too (cp.async.bulk shared -> global in a bulk group),
// so no thread touches the data and one thread per CTA issues everything;
// kernels/probes.py:bulk_copy_plan cuts a copy into about one chunk per SM,
// 1 KB to 16 KB (64 CTAs of 1 KB at the script's 64 KB on 132 SMs), and a
// copy of more chunks than a few CTAs an SM take into 16 KB chunks walked
// by persistent CTAs through a 2-stage ring on two mbarriers, so the next
// chunks' loads are in flight while chunk i is stored. On an H100 the bulk
// load's latency, not the store or the chunking, is what a 64 KB copy pays
// above the launch (PERF.md; probe_sweep.py's ablations).
//
// Each entry point launches on the given stream and returns
// cudaGetLastError(), which the Python wrapper checks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// K up to this is a template parameter of probe_accumulate_kernel; larger K
// runs in batches of this many loads.
constexpr int kMaxUnrolledK = 8;

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Bounded wait on an mbarrier phase: a copy that never completes traps (a
// launch error the wrapper raises on) instead of spinning forever.
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

__global__ void probe_scale_kernel(const float* __restrict__ x,
                                   float* __restrict__ o, int64_t n) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) o[i] = 2.0f * x[i];
}

// One unit of a row gather: a float of x (scalar form) or, in the vector
// form, the float4 at lanes [lane, lane + 4) gathered from the rows that the
// int4 of indices names; where all four name one row (a broadcast index,
// as the reference script's), one 16-byte load, else four 4-byte loads.
__device__ __forceinline__ float gather_unit(const float* x, int row, int64_t lane, int w) {
  return __ldg(x + static_cast<int64_t>(row) * w + lane);
}
__device__ __forceinline__ float4 gather_unit(const float* x, int4 row, int64_t lane, int w) {
  const float* col = x + lane;
  if (row.x == row.y && row.x == row.z && row.x == row.w) {
    return __ldg(reinterpret_cast<const float4*>(col + static_cast<int64_t>(row.x) * w));
  }
  return make_float4(__ldg(col + static_cast<int64_t>(row.x) * w),
                     __ldg(col + static_cast<int64_t>(row.y) * w + 1),
                     __ldg(col + static_cast<int64_t>(row.z) * w + 2),
                     __ldg(col + static_cast<int64_t>(row.w) * w + 3));
}

// x (n, w), idx and o (m, w) in units T (float4 with I = int4: the vector
// form, per_row = w / 4; float with I = int: the scalar form, per_row = w).
// A CTA step covers a tile of VPT * blockDim.x units, thread k taking units
// base + k + v * blockDim.x (v < VPT), so neighbouring threads touch
// neighbouring addresses; tiles are walked grid-stride. Every index load of
// a thread is issued, then every x load, then the stores.
template <typename T, typename I, int VPT>
__global__ void probe_row_gather_kernel(const float* __restrict__ x, const I* __restrict__ idx,
                                        T* __restrict__ o, int64_t units, int per_row,
                                        int w) {
  constexpr int kWidth = sizeof(T) / sizeof(float);
  const int64_t tile = static_cast<int64_t>(VPT) * blockDim.x;
  for (int64_t base = blockIdx.x * tile + threadIdx.x; base < units;
       base += gridDim.x * tile) {
    I row[VPT];
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const int64_t u = base + static_cast<int64_t>(v) * blockDim.x;
      if (u < units) row[v] = __ldg(idx + u);
    }
    T val[VPT];
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const int64_t u = base + static_cast<int64_t>(v) * blockDim.x;
      if (u < units) val[v] = gather_unit(x, row[v], kWidth * (u % per_row), w);
    }
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const int64_t u = base + static_cast<int64_t>(v) * blockDim.x;
      if (u < units) o[u] = val[v];
    }
  }
}

__global__ void probe_flat_gather_kernel(const float* __restrict__ x,
                                         const int32_t* __restrict__ idx,
                                         float* __restrict__ o, int64_t n) {
  int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t < n) o[t] = x[idx[t]];
}

// x, idx, o (m, w): o[i, j] = x[i, idx[i, j]]
__global__ void probe_lane_gather_kernel(const float* __restrict__ x,
                                         const int32_t* __restrict__ idx,
                                         float* __restrict__ o, int64_t mw,
                                         int w) {
  int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= mw) return;
  int64_t row = t / w;
  o[t] = x[row * w + idx[t]];
}

__device__ __forceinline__ float plus_one(float v) { return v + 1.0f; }
__device__ __forceinline__ float4 plus_one(float4 v) {
  return make_float4(v.x + 1.0f, v.y + 1.0f, v.z + 1.0f, v.w + 1.0f);
}

// Output block b = x's block sel[b] + 1, blocks of block_units units T
// (float4: the vector form; float: the scalar form). Tile t covers output
// block t / tiles_per_block, units (t % tiles_per_block) * tile + [0, tile)
// with tile = VPT * blockDim.x, thread k taking units k + v * blockDim.x
// (v < VPT); CTAs walk tiles grid-stride. The tile's warps read sel[b] with
// one uniform load each, then issue all VPT loads before the adds and stores.
template <typename T, int VPT>
__global__ void probe_block_select_kernel(const T* __restrict__ x,
                                          const int32_t* __restrict__ sel,
                                          T* __restrict__ o, int64_t block_units,
                                          int tiles_per_block, int64_t n_tiles) {
  const int64_t tile = static_cast<int64_t>(VPT) * blockDim.x;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t b = t / tiles_per_block;
    const int64_t first = (t - b * tiles_per_block) * tile + threadIdx.x;
    const T* src = x + static_cast<int64_t>(__ldg(sel + b)) * block_units;
    T* dst = o + b * block_units;
    T val[VPT];
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const int64_t u = first + static_cast<int64_t>(v) * blockDim.x;
      if (u < block_units) val[v] = __ldg(src + u);
    }
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const int64_t u = first + static_cast<int64_t>(v) * blockDim.x;
      if (u < block_units) dst[u] = plus_one(val[v]);
    }
  }
}

// The VPT template argument of a launch: 1, 2, 4 or 8 units a thread.
#define PROBE_VPT_SWITCH(vpt, LAUNCH) \
  switch (vpt) {                     \
    case 1: LAUNCH(1); break;        \
    case 2: LAUNCH(2); break;        \
    case 4: LAUNCH(4); break;        \
    case 8: LAUNCH(8); break;        \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

__device__ __forceinline__ void add(float& a, float v) { a += v; }
__device__ __forceinline__ void add(float4& a, const float4& v) {
  a.x += v.x;
  a.y += v.y;
  a.z += v.z;
  a.w += v.w;
}

// x (B, K, per_block) -> o (B, per_block) in units T (float4: the vector
// form, float: the scalar form); units = B * per_block, one unit a thread,
// grid-stride. KT = K for K <= kMaxUnrolledK; KT = 0 takes K at run time,
// kMaxUnrolledK loads at a time. The sum runs k = 0, 1, ..., K-1 from 0.
template <typename T, int KT>
__global__ void probe_accumulate_kernel(const T* __restrict__ x, T* __restrict__ o,
                                        int64_t units, int per_block, int k) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t u = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; u < units;
       u += stride) {
    const int64_t b = u / per_block;
    const T* src = x + b * k * per_block + (u - b * per_block);
    T acc{};
    if (KT > 0) {
      T v[KT > 0 ? KT : 1];
#pragma unroll
      for (int i = 0; i < KT; ++i) v[i] = __ldg(src + static_cast<int64_t>(i) * per_block);
#pragma unroll
      for (int i = 0; i < KT; ++i) add(acc, v[i]);
    } else {
      for (int k0 = 0; k0 < k; k0 += kMaxUnrolledK) {
        const int m = k - k0 < kMaxUnrolledK ? k - k0 : kMaxUnrolledK;
        T v[kMaxUnrolledK];
#pragma unroll
        for (int i = 0; i < kMaxUnrolledK; ++i) {
          if (i < m) v[i] = __ldg(src + static_cast<int64_t>(k0 + i) * per_block);
        }
#pragma unroll
        for (int i = 0; i < kMaxUnrolledK; ++i) {
          if (i < m) add(acc, v[i]);
        }
      }
    }
    o[u] = acc;
  }
}

template <typename T>
void launch_accumulate(const T* x, T* o, int64_t units, int per_block, int k, int threads,
                       int grid, cudaStream_t stream) {
  switch (k) {
#define PROBE_ACC_CASE(KK)                                                   \
  case KK:                                                                   \
    probe_accumulate_kernel<T, KK><<<grid, threads, 0, stream>>>(x, o, units, \
                                                                 per_block, k); \
    break;
    PROBE_ACC_CASE(1)
    PROBE_ACC_CASE(2)
    PROBE_ACC_CASE(3)
    PROBE_ACC_CASE(4)
    PROBE_ACC_CASE(5)
    PROBE_ACC_CASE(6)
    PROBE_ACC_CASE(7)
    PROBE_ACC_CASE(8)
#undef PROBE_ACC_CASE
    default:
      probe_accumulate_kernel<T, 0><<<grid, threads, 0, stream>>>(x, o, units, per_block, k);
  }
}

// n floats (a multiple of 4; 16-byte aligned source and destination) in
// chunks of `chunk` floats (a multiple of 4): CTA b moves chunks b, b + grid,
// ..., the last one possibly short. One thread does it all: it arms a
// stage's mbarrier with the chunk's bytes and issues the bulk load, waits on
// the barrier's phase, and issues the bulk store of the staged chunk in a
// bulk group. Both stages are loaded up front; a stage is refilled with the
// chunk after next once the store from it has read its buffer, so while
// chunk j is stored the loads of chunks j + 1 and j + 2 are in flight.
// Dynamic shared memory holds one stage when every CTA has one chunk, two
// otherwise (kernels/probes.py:bulk_copy_plan). No thread writes the buffer
// through the generic proxy, so no proxy fence sits between load and store.
__global__ void __launch_bounds__(32) probe_bulk_copy_kernel(const float* __restrict__ src,
                                                             float* __restrict__ dst,
                                                             int64_t n, int chunk) {
  extern __shared__ __align__(128) float ring[];
  __shared__ __align__(8) uint64_t full[2];
  const int64_t n_chunks = (n + chunk - 1) / chunk;
  if (threadIdx.x != 0 || blockIdx.x >= n_chunks) return;
  const uint32_t ring_addr = smem_addr(ring);
  const uint32_t stage_bytes = static_cast<uint32_t>(chunk) * 4u;
  for (int s = 0; s < 2; ++s) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_addr(&full[s])), "r"(1) : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");

  auto chunk_bytes = [&](int64_t c) {
    const int64_t rem = n - c * chunk;
    return static_cast<uint32_t>(rem < chunk ? rem : chunk) * 4u;
  };
  auto load = [&](int64_t c, int s) {
    const uint32_t bar = smem_addr(&full[s]);
    const uint32_t bytes = chunk_bytes(c);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(ring_addr + s * stage_bytes), "l"(src + c * chunk), "r"(bytes), "r"(bar)
        : "memory");
  };

  const int64_t step = gridDim.x;
  load(blockIdx.x, 0);
  if (blockIdx.x + step < n_chunks) load(blockIdx.x + step, 1);
  int j = 0;
  for (int64_t c = blockIdx.x; c < n_chunks; c += step, ++j) {
    const int s = j & 1;
    wait_parity(smem_addr(&full[s]), static_cast<uint32_t>(j >> 1) & 1u);
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 :: "l"(dst + c * chunk), "r"(ring_addr + s * stage_bytes),
                    "r"(chunk_bytes(c))
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    if (c + 2 * step < n_chunks) {
      // the store just issued has read stage s before it is refilled
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      load(c + 2 * step, s);
    }
  }
  // the CTA's shared memory must outlive the reads of its last stores
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" {

int probe_scale(const void* x, void* o, int64_t n, void* stream) {
  if (n > 0) {
    probe_scale_kernel<<<blocks_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<float*>(o), n);
  }
  return last_error();
}

// vector != 0: units are float4 (x, idx and o 16-byte aligned, w a
// multiple of 4, per_row = w / 4), else floats (per_row = w).
int probe_row_gather(const void* x, const void* idx, void* o, int64_t units, int per_row,
                     int w, int vector, int vpt, int threads, int grid, void* stream) {
  if (units > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* xf = static_cast<const float*>(x);
    if (vector) {
#define PROBE_ROW_GATHER_VECTOR(V)                                                    \
  probe_row_gather_kernel<float4, int4, V><<<grid, threads, 0, st>>>(                 \
      xf, static_cast<const int4*>(idx), static_cast<float4*>(o), units, per_row, w)
      PROBE_VPT_SWITCH(vpt, PROBE_ROW_GATHER_VECTOR)
#undef PROBE_ROW_GATHER_VECTOR
    } else {
#define PROBE_ROW_GATHER_SCALAR(V)                                                    \
  probe_row_gather_kernel<float, int, V><<<grid, threads, 0, st>>>(                   \
      xf, static_cast<const int*>(idx), static_cast<float*>(o), units, per_row, w)
      PROBE_VPT_SWITCH(vpt, PROBE_ROW_GATHER_SCALAR)
#undef PROBE_ROW_GATHER_SCALAR
    }
  }
  return last_error();
}

int probe_flat_gather(const void* x, const void* idx, void* o, int64_t n,
                      void* stream) {
  if (n > 0) {
    probe_flat_gather_kernel<<<blocks_for(n), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const int32_t*>(idx),
        static_cast<float*>(o), n);
  }
  return last_error();
}

int probe_lane_gather(const void* x, const void* idx, void* o, int64_t mw,
                      int w, void* stream) {
  if (mw > 0) {
    probe_lane_gather_kernel<<<blocks_for(mw), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const int32_t*>(idx),
        static_cast<float*>(o), mw, w);
  }
  return last_error();
}

// vector != 0: units are float4 (x and o 16-byte aligned, a block's floats
// a multiple of 4), else floats; block_units units a block, tiles_per_block
// tiles of vpt * threads units in each of the nsel output blocks.
int probe_block_select(const void* x, const void* sel, void* o, int nsel, int64_t block_units,
                       int tiles_per_block, int vector, int vpt, int threads, int grid,
                       void* stream) {
  if (nsel > 0 && block_units > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int32_t* s = static_cast<const int32_t*>(sel);
    const int64_t n_tiles = static_cast<int64_t>(nsel) * tiles_per_block;
    if (vector) {
#define PROBE_SELECT_VECTOR(V)                                                         \
  probe_block_select_kernel<float4, V><<<grid, threads, 0, st>>>(                      \
      static_cast<const float4*>(x), s, static_cast<float4*>(o), block_units,         \
      tiles_per_block, n_tiles)
      PROBE_VPT_SWITCH(vpt, PROBE_SELECT_VECTOR)
#undef PROBE_SELECT_VECTOR
    } else {
#define PROBE_SELECT_SCALAR(V)                                                         \
  probe_block_select_kernel<float, V><<<grid, threads, 0, st>>>(                       \
      static_cast<const float*>(x), s, static_cast<float*>(o), block_units,           \
      tiles_per_block, n_tiles)
      PROBE_VPT_SWITCH(vpt, PROBE_SELECT_SCALAR)
#undef PROBE_SELECT_SCALAR
    }
  }
  return last_error();
}

// x (B, K, per_block units) -> o; vector != 0: units are float4 (x and o
// 16-byte aligned, per_block = R * W / 4), else floats.
int probe_accumulate(const void* x, void* o, int64_t units, int per_block, int k,
                     int vector, int threads, int grid, void* stream) {
  if (units > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (vector) {
      launch_accumulate(static_cast<const float4*>(x), static_cast<float4*>(o), units,
                        per_block, k, threads, grid, st);
    } else {
      launch_accumulate(static_cast<const float*>(x), static_cast<float*>(o), units,
                        per_block, k, threads, grid, st);
    }
  }
  return last_error();
}

int probe_bulk_copy(const void* src, void* dst, int64_t n, int chunk, int grid, int smem,
                    void* stream) {
  if (n > 0) {
    probe_bulk_copy_kernel<<<grid, 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(src), static_cast<float*>(dst), n, chunk);
  }
  return last_error();
}

}  // extern "C"
