// Capability probes for Hopper (sm_90a): one small kernel per capability
// that the reference package's Mosaic probes tested on the TPU
// (scripts/probe_pallas.py). Each is the Hopper counterpart of its probe,
// not a block-by-block copy:
//
//   probe_scale         <- p_basic (:30)                   elementwise o = 2 x
//   probe_row_gather    <- p_take_along_axis_rows (:40)     o[i,j] = x[idx[i,j], j]
//   probe_flat_gather   <- p_flat_gather (:58)              o = x[idx]
//   probe_lane_gather   <- p_dynamic_gather_lanes (:74)     o[i,j] = x[i, idx[i,j]]
//   probe_block_select  <- p_scalar_prefetch_indexmap (:89) out block b = x block sel[b] + 1;
//                          the source block is chosen by a device index array
//                          read in the kernel (sel[blockIdx.x]), Hopper's form of
//                          the scalar-prefetch index map
//   probe_accumulate    <- p_accumulate_grid (:110)         o[b] = sum_k x[b, k]; one CTA
//                          per output block loops over k in order (the TPU's
//                          revisited output block), no atomics, so the sum order
//                          is fixed
//   probe_bulk_copy     <- p_dma_hbm_to_vmem (:130)         a 1-D bulk asynchronous copy
//                          global -> shared (cp.async.bulk, the TMA's 1-D form)
//                          completing on an mbarrier, then shared -> out; the
//                          counterpart of make_async_copy plus a DMA semaphore
//
// Bound: every probe moves a few KB to 512 KB and does at most one add per
// element, so each is bound by its bytes, and at these sizes by its launch.
//
// Each entry point launches on the given stream and returns
// cudaGetLastError(), which the Python wrapper checks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Floats one CTA stages through shared memory in probe_bulk_copy (16 KB).
constexpr int kBulkFloats = 4096;

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

__global__ void probe_scale_kernel(const float* __restrict__ x,
                                   float* __restrict__ o, int64_t n) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) o[i] = 2.0f * x[i];
}

// x (rows, w), idx and o (m, w)
__global__ void probe_row_gather_kernel(const float* __restrict__ x,
                                        const int32_t* __restrict__ idx,
                                        float* __restrict__ o, int64_t mw,
                                        int w) {
  int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= mw) return;
  int j = static_cast<int>(t % w);
  o[t] = x[static_cast<int64_t>(idx[t]) * w + j];
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

// One CTA per output block; block_elems floats per block.
__global__ void probe_block_select_kernel(const float* __restrict__ x,
                                          const int32_t* __restrict__ sel,
                                          float* __restrict__ o,
                                          int64_t block_elems) {
  const float* src = x + static_cast<int64_t>(sel[blockIdx.x]) * block_elems;
  float* dst = o + static_cast<int64_t>(blockIdx.x) * block_elems;
  for (int64_t e = threadIdx.x; e < block_elems; e += blockDim.x) {
    dst[e] = src[e] + 1.0f;
  }
}

// x (nblocks, k, block_elems) -> o (nblocks, block_elems); one CTA per block.
__global__ void probe_accumulate_kernel(const float* __restrict__ x,
                                        float* __restrict__ o, int k,
                                        int64_t block_elems) {
  const float* src = x + static_cast<int64_t>(blockIdx.x) * k * block_elems;
  float* dst = o + static_cast<int64_t>(blockIdx.x) * block_elems;
  for (int64_t e = threadIdx.x; e < block_elems; e += blockDim.x) {
    float acc = 0.0f;
    for (int kk = 0; kk < k; ++kk) acc += src[kk * block_elems + e];
    dst[e] = acc;
  }
}

// n floats (a multiple of 4, 16-byte aligned source and destination); each
// CTA moves kBulkFloats of them: one thread arms the mbarrier with the byte
// count and issues the bulk copy, every thread waits on phase 0, then the
// CTA writes the staged floats out.
__global__ void probe_bulk_copy_kernel(const float* __restrict__ src,
                                       float* __restrict__ dst, int64_t n) {
  __shared__ __align__(128) float buf[kBulkFloats];
  __shared__ __align__(8) uint64_t bar;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kBulkFloats;
  const int64_t rem = n - base;
  const int count = static_cast<int>(rem < kBulkFloats ? rem : kBulkFloats);
  const uint32_t bytes = static_cast<uint32_t>(count) * 4u;
  const uint32_t bar_addr = static_cast<uint32_t>(__cvta_generic_to_shared(&bar));
  const uint32_t buf_addr = static_cast<uint32_t>(__cvta_generic_to_shared(buf));
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(bar_addr), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar_addr), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(buf_addr), "l"(src + base), "r"(bytes), "r"(bar_addr)
        : "memory");
  }
  // Bounded wait: a copy that never completes traps (a launch error the
  // wrapper raises on) instead of spinning forever.
  uint32_t done = 0;
  for (uint32_t spin = 0; !done; ++spin) {
    if (spin == (1u << 24)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar_addr), "r"(0u) : "memory");
  }
  for (int e = threadIdx.x; e < count; e += blockDim.x) dst[base + e] = buf[e];
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

int probe_row_gather(const void* x, const void* idx, void* o, int64_t mw,
                     int w, void* stream) {
  if (mw > 0) {
    probe_row_gather_kernel<<<blocks_for(mw), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const int32_t*>(idx),
        static_cast<float*>(o), mw, w);
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

int probe_block_select(const void* x, const void* sel, void* o, int nsel,
                       int64_t block_elems, void* stream) {
  if (nsel > 0) {
    probe_block_select_kernel<<<static_cast<unsigned>(nsel), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const int32_t*>(sel),
        static_cast<float*>(o), block_elems);
  }
  return last_error();
}

int probe_accumulate(const void* x, void* o, int nblocks, int k,
                     int64_t block_elems, void* stream) {
  if (nblocks > 0) {
    probe_accumulate_kernel<<<static_cast<unsigned>(nblocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<float*>(o), k, block_elems);
  }
  return last_error();
}

int probe_bulk_copy(const void* src, void* dst, int64_t n, void* stream) {
  if (n > 0) {
    unsigned blocks = static_cast<unsigned>((n + kBulkFloats - 1) / kBulkFloats);
    probe_bulk_copy_kernel<<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(src), static_cast<float*>(dst), n);
  }
  return last_error();
}

}  // extern "C"
