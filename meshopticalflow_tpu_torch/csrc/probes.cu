// Capability probes for Hopper (sm_90a): one small kernel per capability
// that the reference package's Mosaic probes tested on the TPU
// (scripts/probe_pallas.py). Each is the Hopper counterpart of its probe,
// not a block-by-block copy:
//
//   probe_scale         <- p_basic (:30, call :34)         elementwise o = 2 x
//   probe_row_gather    <- p_take_along_axis_rows (:40, call :48)  o[i,j] = x[idx[i,j], j]
//   probe_flat_gather   <- p_flat_gather (:58, call :65)    o = x[idx]
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
// probe_scale: o = 2 x in 16-byte units. Bound: the launch at the script's
// (8,128), the bytes (x read once, o written once) at large sizes. Design:
// the literal port (one float a thread in CTAs of 256, a CTA per 1 KB) paid
// a CTA launch per KB and issued 4-byte accesses, 24 % slower than
// torch.mul at 268 MB; now kernels/probes.py:scale_plan gives one tile of
// threads x VPT float4s a CTA up to a cap, then grid-stride, and a float4 a
// thread in one CTA at the script's 256 vectors (spreading them over more
// CTAs, or two a thread, read slower: probe_sweep.py); a
// thread issues all its VPT loads before its first multiply and store,
// neighbouring threads on neighbouring addresses, with streaming cache
// hints (ld/st.global.cs), which read 0.4 us faster at 268 MB. n % 4 tail
// floats go to CTA 0's first threads; operands not 16-byte aligned take the
// scalar form (one float a unit).
//
// probe_flat_gather: o = x[idx] for any idx. Bound: the launch at the
// script's 1,024 outputs, the bytes (the x elements idx names, idx and o
// once each) at large sizes. Design: the order in which outputs are made,
// not the loads, sets the traffic: at idx = 7 t mod n each of the seven
// sweeps over t touches every 32-byte sector of a 134 MB x, which L2 (50
// MB) cannot hold from one sweep to the next, so x came from HBM ~7 times
// in t order. The outputs are cut into chunks (kernels/probes.py:
// flat_gather_plan, 4,096 outputs), a hand-written rank sort
// (probe_flat_gather_order, three small kernels) orders the chunks by their
// first index as read from idx at run time, and the gather walks chunks in
// that order on a capped grid, each CTA a contiguous run of the order, so
// the chunks that read one region of x run one after another on one SM and
// share it in L1 (in L2, walking the order grid-stride, which leaves each
// sector to be fetched into ~7 SMs, read slower on an H100: probe_sweep.py,
// "gather_strided"). A thread loads an int4 of idx, issues the four x
// loads, stores a float4 of o. Below two chunks the plan skips the ordering
// pass and spreads the tiles over the SMs. Operands not 16-byte aligned take
// the scalar form.
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

__device__ __forceinline__ float twice(float v) { return 2.0f * v; }
__device__ __forceinline__ float4 twice(float4 v) {
  return make_float4(2.0f * v.x, 2.0f * v.y, 2.0f * v.z, 2.0f * v.w);
}

// o = 2 x over `units` units T (float4: the vector form; float: the scalar
// form), then `tail` (< 4) floats past them. A CTA step covers a tile of
// VPT * blockDim.x units, thread k taking units base + k + v * blockDim.x
// (v < VPT), so neighbouring threads touch neighbouring addresses; tiles are
// walked grid-stride. Every load of a thread is issued before its first
// multiply and store, both with the streaming (evict-first) hint: a pass
// over more than L2 holds gains nothing from keeping its lines. CTA 0's
// first `tail` threads take the tail floats.
template <typename T, int VPT>
__global__ void probe_scale_kernel(const T* __restrict__ x, T* __restrict__ o, int64_t units,
                                   int tail) {
  const int64_t tile = static_cast<int64_t>(VPT) * blockDim.x;
  for (int64_t base = blockIdx.x * tile + threadIdx.x; base < units;
       base += gridDim.x * tile) {
    T val[VPT];
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const int64_t u = base + static_cast<int64_t>(v) * blockDim.x;
      if (u < units) val[v] = __ldcs(x + u);
    }
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const int64_t u = base + static_cast<int64_t>(v) * blockDim.x;
      if (u < units) __stcs(o + u, twice(val[v]));
    }
  }
  if (blockIdx.x == 0 && static_cast<int>(threadIdx.x) < tail) {
    const int64_t f = units * (sizeof(T) / sizeof(float)) + threadIdx.x;
    reinterpret_cast<float*>(o)[f] = 2.0f * __ldg(reinterpret_cast<const float*>(x) + f);
  }
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

// One unit of a flat gather: the float x[i], or the float4 of the four
// floats that an int4 of indices names (four 4-byte loads, issued together).
__device__ __forceinline__ float flat_unit(const float* x, int i) { return __ldg(x + i); }
__device__ __forceinline__ float4 flat_unit(const float* x, int4 i) {
  return make_float4(__ldg(x + i.x), __ldg(x + i.y), __ldg(x + i.z), __ldg(x + i.w));
}

// o = x[idx] over `units` units (T = float4 with I = int4: the vector form;
// float with I = int: the scalar form), then `tail` (< 4) floats past them.
// The units are cut into chunks of chunk_units, each of 2^tpc_shift tiles
// of VPT * blockDim.x units. Without an order, step s is tile s of the
// units; with one, step s is tile s % 2^tpc_shift of chunk order[p], p = s
// >> tpc_shift. CTA b takes the contiguous run of steps [b * per, (b + 1) *
// per) (per = ceil(n_steps / grid), from the host), so one SM works through
// neighbouring positions of the order, whose
// chunks read one region of x, and finds most of it in its L1. Thread k
// takes units first + k + v * blockDim.x (v < VPT): every index load is
// issued, then every x load, then the stores. Every unit lies in one chunk
// and every chunk at one position, so each output is written once whatever
// the order.
template <typename T, typename I, int VPT>
__global__ void probe_flat_gather_kernel(const float* __restrict__ x, const I* __restrict__ idx,
                                         T* __restrict__ o, const int32_t* __restrict__ order,
                                         int64_t units, int64_t chunk_units, int tpc_shift,
                                         int64_t n_steps, int64_t per, int tail) {
  const int64_t tile = static_cast<int64_t>(VPT) * blockDim.x;
  const int64_t stop = (blockIdx.x + 1) * per < n_steps ? (blockIdx.x + 1) * per : n_steps;
  for (int64_t s = blockIdx.x * per; s < stop; ++s) {
    int64_t first = s * tile + threadIdx.x, end = units;
    if (order != nullptr) {
      const int64_t start = static_cast<int64_t>(__ldg(order + (s >> tpc_shift))) * chunk_units;
      end = start + chunk_units < units ? start + chunk_units : units;
      first = start + (s & ((int64_t{1} << tpc_shift) - 1)) * tile + threadIdx.x;
    }
    I k[VPT];
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const int64_t u = first + static_cast<int64_t>(v) * blockDim.x;
      if (u < end) k[v] = __ldg(idx + u);
    }
    T val[VPT];
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const int64_t u = first + static_cast<int64_t>(v) * blockDim.x;
      if (u < end) val[v] = flat_unit(x, k[v]);
    }
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const int64_t u = first + static_cast<int64_t>(v) * blockDim.x;
      if (u < end) o[u] = val[v];
    }
  }
  if (blockIdx.x == 0 && static_cast<int>(threadIdx.x) < tail) {
    const int64_t f = units * (sizeof(T) / sizeof(float)) + threadIdx.x;
    reinterpret_cast<float*>(o)[f] = __ldg(x + __ldg(reinterpret_cast<const int*>(idx) + f));
  }
}

// The ordering pass of the flat gather: chunk ids 0 .. n_chunks-1 sorted by
// key[c] = idx[c * stride] (a chunk's first index), ties by id, as a rank
// sort that is exact and deterministic. (1) probe_order_tile_kernel: one CTA
// per tile of kOrderTile chunks ranks each key within its tile by a scan of
// the tile's keys in shared memory, writes the tile's keys in sorted order
// and the rank. (2) probe_order_merge_kernel: CTA (a, b), a != b, loads tile
// b's sorted keys and adds to each key of tile a the count of tile b's keys
// that precede it (binary search: keys <= k from a lower tile, < k from a
// higher one), with integer atomics, so the sums do not depend on their
// order. (3) probe_order_scatter_kernel: order[rank[c]] = c.
constexpr int kOrderTile = 256;

__global__ void __launch_bounds__(kOrderTile) probe_order_tile_kernel(
    const int32_t* __restrict__ idx, int64_t stride, int n_chunks,
    int32_t* __restrict__ sorted, int32_t* __restrict__ rank) {
  __shared__ int32_t keys[kOrderTile];
  const int base = blockIdx.x * kOrderTile;
  const int m = n_chunks - base < kOrderTile ? n_chunks - base : kOrderTile;
  const int i = threadIdx.x;
  if (i < m) keys[i] = __ldg(idx + static_cast<int64_t>(base + i) * stride);
  __syncthreads();
  if (i >= m) return;
  const int32_t k = keys[i];
  int r = 0;
  for (int j = 0; j < m; ++j) {
    const int32_t kj = keys[j];
    r += (kj < k) || (kj == k && j < i);
  }
  sorted[base + r] = k;
  rank[base + i] = r;
}

__global__ void __launch_bounds__(kOrderTile) probe_order_merge_kernel(
    const int32_t* __restrict__ idx, int64_t stride, int n_chunks,
    const int32_t* __restrict__ sorted, int32_t* __restrict__ rank) {
  const int a = blockIdx.x, b = blockIdx.y;
  if (a == b) return;
  __shared__ int32_t keys[kOrderTile];
  const int base_b = b * kOrderTile;
  const int mb = n_chunks - base_b < kOrderTile ? n_chunks - base_b : kOrderTile;
  if (static_cast<int>(threadIdx.x) < mb) keys[threadIdx.x] = sorted[base_b + threadIdx.x];
  __syncthreads();
  const int e = a * kOrderTile + threadIdx.x;
  if (e >= n_chunks) return;
  const int32_t k = __ldg(idx + static_cast<int64_t>(e) * stride);
  int lo = 0, hi = mb;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (b < a ? keys[mid] <= k : keys[mid] < k) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  if (lo) atomicAdd(rank + e, lo);
}

__global__ void probe_order_scatter_kernel(const int32_t* __restrict__ rank, int n_chunks,
                                           int32_t* __restrict__ order) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < n_chunks) order[rank[c]] = c;
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

// vector != 0: units are float4 (x and o 16-byte aligned; tail = n % 4
// floats follow them), else floats (tail = 0).
int probe_scale(const void* x, void* o, int64_t units, int tail, int vector, int vpt,
                int threads, int grid, void* stream) {
  if (units > 0 || tail > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (vector) {
#define PROBE_SCALE_VECTOR(V)                                                         \
  probe_scale_kernel<float4, V><<<grid, threads, 0, st>>>(                            \
      static_cast<const float4*>(x), static_cast<float4*>(o), units, tail)
      PROBE_VPT_SWITCH(vpt, PROBE_SCALE_VECTOR)
#undef PROBE_SCALE_VECTOR
    } else {
#define PROBE_SCALE_SCALAR(V)                                                         \
  probe_scale_kernel<float, V><<<grid, threads, 0, st>>>(                             \
      static_cast<const float*>(x), static_cast<float*>(o), units, tail)
      PROBE_VPT_SWITCH(vpt, PROBE_SCALE_SCALAR)
#undef PROBE_SCALE_SCALAR
    }
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

// vector != 0: units are float4 of o and int4 of idx (idx and o 16-byte
// aligned; tail = n % 4 floats follow them), else floats (tail = 0). order
// (n_chunks chunk ids, from probe_flat_gather_order) or null: chunk order.
int probe_flat_gather(const void* x, const void* idx, void* o, const void* order,
                      int64_t units, int64_t chunk_units, int tail, int vector, int vpt,
                      int threads, int grid, void* stream) {
  const int64_t tile = static_cast<int64_t>(vpt) * threads;
  if (tile <= 0 || grid <= 0 || chunk_units <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (units > 0 || tail > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* xf = static_cast<const float*>(x);
    const int32_t* ord = static_cast<const int32_t*>(order);
    int tpc_shift = 0;   // chunk_units = tile * 2^tpc_shift, or the launch is refused
    while ((tile << tpc_shift) < chunk_units) ++tpc_shift;
    if ((tile << tpc_shift) != chunk_units) return static_cast<int>(cudaErrorInvalidValue);
    // with an order, every tile of every chunk (step s in the chunk at
    // position s >> tpc_shift); without one, the tiles that hold units
    const int64_t n_steps = ord != nullptr
                                ? ((units + chunk_units - 1) / chunk_units) << tpc_shift
                                : (units + tile - 1) / tile;
    const int64_t per = (n_steps + grid - 1) / grid;
    if (vector) {
#define PROBE_FLAT_VECTOR(V)                                                            \
  probe_flat_gather_kernel<float4, int4, V><<<grid, threads, 0, st>>>(                  \
      xf, static_cast<const int4*>(idx), static_cast<float4*>(o), ord, units, chunk_units, \
      tpc_shift, n_steps, per, tail)
      PROBE_VPT_SWITCH(vpt, PROBE_FLAT_VECTOR)
#undef PROBE_FLAT_VECTOR
    } else {
#define PROBE_FLAT_SCALAR(V)                                                            \
  probe_flat_gather_kernel<float, int, V><<<grid, threads, 0, st>>>(                    \
      xf, static_cast<const int*>(idx), static_cast<float*>(o), ord, units, chunk_units,  \
      tpc_shift, n_steps, per, tail)
      PROBE_VPT_SWITCH(vpt, PROBE_FLAT_SCALAR)
#undef PROBE_FLAT_SCALAR
    }
  }
  return last_error();
}

// order = chunk ids 0 .. n_chunks-1 sorted by idx[c * stride], ties by id;
// scratch holds 2 * n_chunks int32 (sorted tile keys, ranks).
int probe_flat_gather_order(const void* idx, void* scratch, void* order, int64_t n_chunks,
                            int64_t stride, void* stream) {
  const int64_t n_tiles = (n_chunks + kOrderTile - 1) / kOrderTile;
  if (n_chunks > 0x7fffffff || n_tiles > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_chunks > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int32_t* ix = static_cast<const int32_t*>(idx);
    int32_t* sorted = static_cast<int32_t*>(scratch);
    int32_t* rank = sorted + n_chunks;
    const int n = static_cast<int>(n_chunks);
    const unsigned t = static_cast<unsigned>(n_tiles);
    probe_order_tile_kernel<<<t, kOrderTile, 0, st>>>(ix, stride, n, sorted, rank);
    if (t > 1) {
      probe_order_merge_kernel<<<dim3(t, t), kOrderTile, 0, st>>>(ix, stride, n, sorted,
                                                                   rank);
    }
    probe_order_scatter_kernel<<<t, kOrderTile, 0, st>>>(rank, n,
                                                         static_cast<int32_t*>(order));
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
