// Banded Cholesky kernels for Hopper (sm_90a). The reference package runs
// the blocked banded Cholesky and its two panel sweeps as lax.scans, with no
// Pallas kernel (meshopticalflow_tpu/solvers/banded.py):
//
//   panel_sweep_{p}_{t}    <- panel_lower_solve (:206) and panel_upper_solve
//                             (:224): L y = b and L^T x = y on the solve
//                             panels, panels and rhs of one type (f32,
//                             f64), or bf16 panels widened in registers to
//                             an f32 or f64 rhs; 1 to 32 right-hand sides
//   band_factor_{f32,f64}  <- band_cholesky (:130): the right-looking blocked
//                             factorization over the m block steps of 128
//
// Both are chains of dependent steps (a panel's product needs the last
// panel's result; a block step needs the last step's Schur update), which
// the plain PyTorch versions (kernels/banded.py: *_plain) issue as a few
// small library calls a step. Each kernel here is ONE cooperative launch of
// a persistent grid, at most one 256-thread block an SM, whose blocks meet
// at a grid-wide barrier (cooperative_groups grid sync) between dependent
// phases. The launch is refused, never run, when the grid cannot be
// co-resident (cudaLaunchCooperativeKernel checks it), so a barrier cannot
// deadlock.
//
// panel_sweep: bound by bytes. A sweep reads each panel's S x S inverse
// diagonal and bw x S band once, whole (2 x 113 MB in f32 for the flow c1
// system), though the inverse's upper half and the band's blocks past the
// staircase are zero; the vectors are a few KB. Each panel step is two
// products, so two barriers:
//   lower: y_i = Dinv_i (b_i - acc[:S]);  acc <- [acc[S:]; 0] + Pbelow_i y_i
//   upper: t = y_i - Pbelow_i^T xwin;      x_i = Dinv_i^T t
// A product by rows (lower) gives one warp a row, its lanes along the
// row, so each load is 128 contiguous bytes; a product by columns (upper)
// gives a block a tile of 8 columns (16 for bf16: 32 bytes a matrix row)
// and its threads 32 (16) slices of the depth, summed across the block's
// warps in shared memory. The vector a product needs is staged in shared
// memory once a block (rows padded by one value, against bank conflicts).
// The lower sweep's window acc lives in two global buffers, used in turn;
// the upper sweep's window is the solution already written (xwin[k] =
// x[(i+1) S + k]). A phase issues its first batch of matrix loads (a whole
// row at the main path's widths) before the barrier that makes its vector
// ready, so the loads are in flight while the grid meets; what is left of
// a phase is the barrier (banded_grid_sync times one), one L2 round trip
// for the vector and the sums. Every sum runs in a fixed
// order (lanes, then a warp butterfly, then warps in turn), so two runs
// agree bit for bit. Values written by one block and read by another
// after a barrier are loaded with __ldcg (L2, not the SM's L1).
//
// band_factor: bound by operations: each block step is a bw x bw Schur
// update of rank nb (2 bw^2 nb operations as the plain version computes it;
// this kernel computes only its lower half, the only half anything reads).
// The critical path is serial: each step factors its nb x nb diagonal
// block, then solves the band below it, then updates the window. Three
// phases a step, a barrier after each (nb = 128, a template parameter, so
// every index is a shift):
//   1. block 0: d = tril(s_i[:nb]) + W[:nb, :nb] + shift I (the lower half,
//      all that a Cholesky reads), held in registers over the block's
//      16 x 16 threads and factored right-looking, a column a round (one
//      block barrier a column: the longest serial part of a step); a
//      pivot that is not > 0 or a non-finite entry makes the step bad:
//      ld = I, lp = 0, and flags[0] (bad at any step) is set, on the
//      device, for the caller to read when it chooses;
//   2. every block: lp = (s_i[nb:] + W[nb:, :nb]) ld^-T, one warp a row
//      (loaded before the barrier), by forward substitution with ld in
//      shared memory (padded rows);
//   3. every block: W_next(r, c) = W(r + nb, c + nb) - lp[r] . lp[c] for
//      c <= r, in 64 x 64 tiles (a thread 4 x 4 outputs, lp staged in
//      shared memory 32 columns at a time).
// W is kept as a bw x bw circular window in global memory: logical row and
// column 0 sit at physical offset `off`, which moves by nb a step, so the
// window never moves: W_next(r, c) is written where W(r + nb, c + nb) was
// read, by the thread that read it.
//
// Each entry point launches on the given stream and returns the cooperative
// launch's error code, which the Python wrapper checks (with
// banded_last_launch's grid for its message).
// The caller zeroes the sweep's first window buffer, the factor's window
// and its flags.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStageBytes = 32 * 1024;   // a sweep's staged vector tile
constexpr int kTile = 64;                // the Schur update's output tile
constexpr int kDepthChunk = 32;          // its depth staged at a time

// A panel value in the rhs type: bf16 widens exactly (as torch's .to), a
// wider type rounds to nearest.
template <typename T, typename P>
struct Widen {
  static __device__ __forceinline__ T of(P v) { return static_cast<T>(v); }
};
template <typename T>
struct Widen<T, __nv_bfloat16> {
  static __device__ __forceinline__ T of(__nv_bfloat16 v) {
    return static_cast<T>(__bfloat162float(v));
  }
};

// Row stride of a staged vector tile: CT columns and one spare.
template <int CT>
struct Pad {
  static constexpr int value = CT == 1 ? 1 : CT + 1;
};

// Columns of a by-column product's tile: 32 bytes of a matrix row or more.
template <typename P>
struct ColTile {
  static constexpr int value = sizeof(P) == 2 ? 16 : 8;
};

// Loads a thread keeps in flight in a product: a whole row (column slice)
// at the main path's widths, fewer where many right-hand sides hold
// registers.
template <int CT>
struct Batch {
  static constexpr int value = CT <= 4 ? 32 : (CT <= 8 ? 16 : 8);
};

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// n values, U a thread at a time: all U loads issued before the stores.
template <typename T, int U, typename L, typename S>
__device__ __forceinline__ void batched(int n, L load, S store) {
  for (int e0 = threadIdx.x; e0 < n; e0 += kThreads * U) {
    T v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * kThreads;
      if (e < n) v[u] = load(e);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * kThreads;
      if (e < n) store(e, v[u]);
    }
  }
}

template <typename T, int CT, typename V>
__device__ __forceinline__ void stage(T* vs, int k0, int kn, int c, V vec) {
  constexpr int VS = Pad<CT>::value;
  batched<T, 8>(
      kn * CT,
      [&](int e) {
        const int k = e / CT, j = e - k * CT;
        return j < c ? vec(k0 + k, j) : T(0);
      },
      [&](int e, T v) {
        const int k = e / CT;
        vs[k * VS + e - k * CT] = v;
      });
}

// put(r, j, mat[r, :] . vec(:, j)) for r < rows, mat (rows, depth) row-major:
// one warp a row (rows spread over every warp of the grid), lanes along it.
// The first batch of matrix loads is issued before sync(), the grid
// barrier that makes vec ready, so it is in flight across the barrier.
template <typename P, typename T, int CT, typename V, typename W, typename S>
__device__ void row_products(const P* __restrict__ mat, int rows, int depth, int c, int kt,
                             T* vs, V vec, W put, S sync) {
  constexpr int VS = Pad<CT>::value;
  constexpr int B = Batch<CT>::value;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int total = gridDim.x * kWarps;
  const int passes = (rows + total - 1) / total;
  const int tiles = (depth + kt - 1) / kt;
  P a[B];
  auto load = [&](int r, int k0, int kn, int kb) {
    const P* row = mat + (size_t)r * depth + k0;
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int k = kb + 32 * u + lane;
      if (k < kn) a[u] = row[k];
    }
  };
  const int r_first = blockIdx.x * kWarps + warp;
  if (r_first < rows) load(r_first, 0, min(kt, depth), 0);
  sync();
  for (int pass = 0; pass < passes; ++pass) {
    const int r = pass * total + r_first;
    T acc[CT];
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[j] = T(0);
    for (int tile = 0; tile < tiles; ++tile) {
      const int k0 = tile * kt, kn = min(kt, depth - k0);
      if (tiles > 1 || pass == 0) {
        __syncthreads();
        stage<T, CT>(vs, k0, kn, c, vec);
        __syncthreads();
      }
      if (r < rows) {
        for (int kb = 0; kb < kn; kb += 32 * B) {
          if (pass > 0 || tile > 0 || kb > 0) load(r, k0, kn, kb);
#pragma unroll
          for (int u = 0; u < B; ++u) {
            const int k = kb + 32 * u + lane;
            if (k < kn) {
              const T av = Widen<T, P>::of(a[u]);
              const T* v = vs + k * VS;
#pragma unroll
              for (int j = 0; j < CT; ++j) acc[j] += av * v[j];
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < CT; ++j) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc[j] += __shfl_xor_sync(kFull, acc[j], o);
    }
    if (r < rows) {
#pragma unroll
      for (int j = 0; j < CT; ++j)
        if (lane == j && j < c) put(r, j, acc[j]);
    }
  }
}

// put(r, j, mat[:, r] . vec(:, j)) for r < cols, mat (depth, cols) row-major:
// a block a tile of RT columns, its threads KS slices of the depth; the
// slices are summed in a warp, then the warps in turn in shared memory.
// The first batch of matrix loads is issued before sync(), as above.
template <typename P, typename T, int CT, typename V, typename W, typename S>
__device__ void column_products(const P* __restrict__ mat, int cols, int depth, int c, int kt,
                                T* vs, T* red, V vec, W put, S sync) {
  constexpr int VS = Pad<CT>::value;
  constexpr int RT = ColTile<P>::value;
  constexpr int KS = kThreads / RT;
  constexpr int B = Batch<CT>::value;
  const int rr = threadIdx.x % RT, ks = threadIdx.x / RT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ctiles = (cols + RT - 1) / RT;
  const int tiles = (depth + kt - 1) / kt;
  P a[B];
  auto load = [&](int r, int k0, int kn, int kb) {
    const P* col = mat + (size_t)k0 * cols + r;
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int k = kb + KS * u + ks;
      if (k < kn) a[u] = col[(size_t)k * cols];
    }
  };
  const int r_first = blockIdx.x * RT + rr;
  if (blockIdx.x < ctiles && r_first < cols) load(r_first, 0, min(kt, depth), 0);
  sync();
  bool staged = false;
  for (int ct = blockIdx.x; ct < ctiles; ct += gridDim.x) {
    const int r = ct * RT + rr;
    T acc[CT];
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[j] = T(0);
    for (int tile = 0; tile < tiles; ++tile) {
      const int k0 = tile * kt, kn = min(kt, depth - k0);
      if (tiles > 1 || !staged) {
        __syncthreads();
        stage<T, CT>(vs, k0, kn, c, vec);
        __syncthreads();
      }
      if (r < cols) {
        for (int kb = 0; kb < kn; kb += KS * B) {
          if (staged || tile > 0 || kb > 0) load(r, k0, kn, kb);
#pragma unroll
          for (int u = 0; u < B; ++u) {
            const int k = kb + KS * u + ks;
            if (k < kn) {
              const T av = Widen<T, P>::of(a[u]);
              const T* v = vs + k * VS;
#pragma unroll
              for (int j = 0; j < CT; ++j) acc[j] += av * v[j];
            }
          }
        }
      }
    }
    staged = true;
    // lane = (slice mod 32/RT) * RT + rr: fold the warp's slices onto lanes < RT
#pragma unroll
    for (int j = 0; j < CT; ++j) {
#pragma unroll
      for (int o = 16; o >= RT; o >>= 1) acc[j] += __shfl_xor_sync(kFull, acc[j], o);
    }
    __syncthreads();
    if (lane < RT) {
#pragma unroll
      for (int j = 0; j < CT; ++j) red[(warp * RT + lane) * CT + j] = acc[j];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < RT * CT; e += kThreads) {
      const int q = e / CT, j = e - q * CT, r2 = ct * RT + q;
      T sum = T(0);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[(w * RT + q) * CT + j];
      if (r2 < cols && j < c) put(r2, j, sum);
    }
  }
}

// dinv (mp, S, S), pbelow (mp, bw, S) in P; rhs and out (mp, S, c) in T;
// scratch: lower 2 x bw x c (the first buffer zero), upper S x c.
template <typename P, typename T, int CT>
__global__ void __launch_bounds__(kThreads)
    panel_sweep_kernel(const P* __restrict__ dinv, const P* __restrict__ pbelow,
                       const T* __restrict__ rhs, T* __restrict__ out, T* __restrict__ scratch,
                       int mp, int s, int bw, int c, int upper, int kt) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* vs = reinterpret_cast<T*>(smem);
  T* red = vs + kt * Pad<CT>::value;
  cg::grid_group grid = cg::this_grid();
  const size_t sc = (size_t)s * c;
  if (!upper) {
    for (int i = 0; i < mp; ++i) {
      const T* cur = scratch + (size_t)(i & 1) * bw * c;
      T* nxt = scratch + (size_t)((i + 1) & 1) * bw * c;
      const T* b = rhs + i * sc;
      T* y = out + i * sc;
      row_products<P, T, CT>(
          dinv + (size_t)i * s * s, s, s, c, kt, vs,
          [&](int k, int j) { return b[k * c + j] - __ldcg(cur + k * c + j); },
          [&](int r, int j, T v) { y[r * c + j] = v; },
          [&] {
            if (i > 0) grid.sync();
          });
      row_products<P, T, CT>(
          pbelow + (size_t)i * bw * s, bw, s, c, kt, vs,
          [&](int k, int j) { return __ldcg(y + k * c + j); },
          [&](int r, int j, T v) {
            nxt[r * c + j] = (r + s < bw ? __ldcg(cur + (r + s) * c + j) : T(0)) + v;
          },
          [&] { grid.sync(); });
    }
  } else {
    T* t = scratch;
    const size_t total = (size_t)mp * s;
    for (int i = mp - 1; i >= 0; --i) {
      const T* y = rhs + i * sc;
      T* x = out + i * sc;
      const size_t base = (size_t)(i + 1) * s;   // xwin[k] = x[base + k], 0 past the end
      column_products<P, T, CT>(
          pbelow + (size_t)i * bw * s, s, bw, c, kt, vs, red,
          [&](int k, int j) {
            return base + k < total ? __ldcg(out + (base + k) * c + j) : T(0);
          },
          [&](int r, int j, T v) { t[r * c + j] = y[r * c + j] - v; },
          [&] {
            if (i + 1 < mp) grid.sync();
          });
      column_products<P, T, CT>(
          dinv + (size_t)i * s * s, s, s, c, kt, vs, red,
          [&](int k, int j) { return __ldcg(t + k * c + j); },
          [&](int r, int j, T v) { x[r * c + j] = v; }, [&] { grid.sync(); });
    }
  }
}

__device__ __forceinline__ int wrap(int x, int bw) { return x >= bw ? x - bw : x; }

// W(r, c) of the circular window whose logical origin sits at `off`.
template <typename T>
__device__ __forceinline__ T window(const T* w, int r, int c, int off, int bw) {
  return __ldcg(w + (size_t)wrap(r + off, bw) * bw + wrap(c + off, bw));
}

// Phase 1 (block 0): factor the step's diagonal block into out[i, :NB].
// The block's 16 x 16 threads hold the block's lower half in registers,
// thread (ty, tx) the entries (ty + 16 p, tx + 16 q), q <= p; right-looking,
// a column a round, one barrier a round: the owners of column j + 1 (tx =
// (j + 1) % 16) publish its updated values in a shared buffer (two, used in
// turn), from which every thread takes the pivot and scales the column as
// it reads it; L = A * (1 / ljj), as LAPACK's potf2 scales.
template <typename T, int NB>
__device__ void factor_diagonal(const T* si, T* oi, const T* w, int* flags, int off, int bw,
                                T shift, T* sm) {
  constexpr int QN = NB / 16;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  T a[QN][QN];
#pragma unroll
  for (int p = 0; p < QN; ++p)
#pragma unroll
    for (int q = 0; q <= p; ++q) {
      const int r = ty + 16 * p, c = tx + 16 * q;
      a[p][q] = T(0);
      if (q < p || tx <= ty) {
        a[p][q] = si[r * NB + c] + window(w, r, c, off, bw);
        if (r == c) a[p][q] += shift;
      }
    }
  if (tx == 0) {
#pragma unroll
    for (int p = 0; p < QN; ++p) sm[ty + 16 * p] = a[p][0];
  }
  __syncthreads();
  bool bad = false;
#pragma unroll
  for (int q0 = 0; q0 < QN; ++q0) {
    for (int jj = 0; jj < 16; ++jj) {
      const int j = 16 * q0 + jj;
      const T* buf = sm + (j & 1) * NB;
      const T piv = buf[j];
      const T ljj = sqrt(piv), rl = T(1) / ljj;
      bad = bad || !(piv > T(0));
      T lr[QN], lc[QN];
#pragma unroll
      for (int p = q0; p < QN; ++p) {
        lr[p] = buf[ty + 16 * p] * rl;
        lc[p] = buf[tx + 16 * p] * rl;
      }
      if (tx == jj) {   // this thread's column j: its L values
#pragma unroll
        for (int p = q0; p < QN; ++p) {
          const int r = ty + 16 * p;
          if (r > j) a[p][q0] = lr[p];
          if (r == j) a[p][q0] = ljj;
        }
      }
#pragma unroll
      for (int p = q0; p < QN; ++p)
#pragma unroll
        for (int q = q0; q <= p; ++q) {
          bool upd = true;
          if (q == q0) upd = tx + 16 * q > j;
          if (q == p) upd = upd && tx <= ty;
          if (upd) a[p][q] -= lr[p] * lc[q];
        }
      if (tx == ((j + 1) & 15) && j + 1 < NB) {   // publish column j + 1
        T* next = sm + ((j + 1) & 1) * NB;
#pragma unroll
        for (int p = q0; p < QN; ++p) {
          const int r = ty + 16 * p;
          if (jj < 15) {
            if (r > j) next[r] = a[p][q0];
          } else if (p > q0) {
            next[r] = a[p][q0 + 1 < QN ? q0 + 1 : q0];
          }
        }
      }
      __syncthreads();
    }
  }
  int nonfinite = 0;
#pragma unroll
  for (int p = 0; p < QN; ++p)
#pragma unroll
    for (int q = 0; q <= p; ++q)
      if ((q < p || tx <= ty) && !isfinite(a[p][q])) nonfinite = 1;
  const int any_bad = __syncthreads_or(nonfinite || (tid == 0 && bad));
#pragma unroll
  for (int p = 0; p < QN; ++p)
#pragma unroll
    for (int q = 0; q < QN; ++q) {
      const int r = ty + 16 * p, c = tx + 16 * q;
      T v = T(0);
      if (q < p || (q == p && tx <= ty)) v = a[p][q < p ? q : p];
      oi[r * NB + c] = any_bad ? T(r == c ? 1 : 0) : v;
    }
  if (tid == 0) {
    flags[1] = any_bad;
    if (any_bad) flags[0] = 1;
  }
}

// Phase 2 (every block): lp = (s_i[NB:] + W[NB:, :NB]) ld^-T into
// out[i, NB:], one warp a row; lane l holds columns l, l + 32, ... A
// warp's first row is loaded before sync(), the barrier after phase 1 (W
// is final for the step by then); the diagonal's reciprocals are taken once
// a block.
template <typename T, int NB, typename S>
__device__ void solve_below(const T* si, T* oi, const T* w, const int* flags, int off, int bw,
                            T* sm, S sync) {
  constexpr int LD = NB + 1, X = NB / 32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int total = gridDim.x * kWarps;
  T* rd = sm + NB * LD;
  T x[X];
  auto load = [&](int r) {
    const T* prow = si + (size_t)(NB + r) * NB;
#pragma unroll
    for (int q = 0; q < X; ++q) {
      const int c = lane + 32 * q;
      x[q] = prow[c] + (NB + r < bw ? window(w, NB + r, c, off, bw) : T(0));
    }
  };
  const int r_first = blockIdx.x * kWarps + warp;
  if (r_first < bw) load(r_first);
  sync();
  const bool bad = __ldcg(flags + 1) != 0;
  if (!bad) {
    batched<T, 16>(
        NB * NB,
        [&](int e) {
          const int r = e / NB, c = e - r * NB;
          return c <= r ? __ldcg(oi + e) : T(0);
        },
        [&](int e, T v) {
          const int r = e / NB, c = e - r * NB;
          if (c < r) sm[r * LD + c] = v;
          if (c == r) rd[r] = T(1) / v;
        });
  }
  __syncthreads();
  for (int r = r_first; r < bw; r += total) {
    if (r != r_first) load(r);
    if (!bad) {
#pragma unroll
      for (int q = 0; q < X; ++q) {
        for (int jl = 0; jl < 32; ++jl) {
          const int j = 32 * q + jl;
          const T xj = __shfl_sync(kFull, x[q], jl) * rd[j];
          if (lane == jl) x[q] = xj;
          if (lane > jl) x[q] -= xj * sm[(lane + 32 * q) * LD + j];
#pragma unroll
          for (int u = q + 1; u < X; ++u) x[u] -= xj * sm[(lane + 32 * u) * LD + j];
        }
      }
    }
    T* lrow = oi + (size_t)(NB + r) * NB;
#pragma unroll
    for (int q = 0; q < X; ++q) lrow[lane + 32 * q] = bad ? T(0) : x[q];
  }
}

// Phase 3 (every block): W_next(r, c) = W(r + NB, c + NB) - lp[r] . lp[c] for
// c <= r < bw, 64 x 64 tiles of the lower half spread over the blocks.
template <typename T, int NB>
__device__ void schur_update(const T* lp, T* w, int off, int bw, T* sm) {
  constexpr int TP = kTile + 1;
  T* as = sm;
  T* bs = sm + kDepthChunk * TP;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nt = (bw + kTile - 1) / kTile;
  const int count = nt * (nt + 1) / 2;
  const int next = wrap(off + NB, bw);
  for (int t = blockIdx.x; t < count; t += gridDim.x) {
    int ta = 0;
    while ((ta + 1) * (ta + 2) / 2 <= t) ++ta;
    const int r0 = ta * kTile, c0 = (t - ta * (ta + 1) / 2) * kTile;
    T acc[4][4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][q] = T(0);
#pragma unroll 1
    for (int k0 = 0; k0 < NB; k0 += kDepthChunk) {
      __syncthreads();
      // element e < 2 * 32 * 64: e / 2048 picks the tile (rows r0.. or c0..)
      batched<T, 16>(
          2 * kDepthChunk * kTile,
          [&](int e) {
            const int h = e / (kDepthChunk * kTile), f = e - h * kDepthChunk * kTile;
            const int q = f / kDepthChunk, k = k0 + f - q * kDepthChunk;
            const int row = (h ? c0 : r0) + q;
            return row < bw ? __ldcg(lp + (size_t)row * NB + k) : T(0);
          },
          [&](int e, T v) {
            const int h = e / (kDepthChunk * kTile), f = e - h * kDepthChunk * kTile;
            const int q = f / kDepthChunk, kk = f - q * kDepthChunk;
            (h ? bs : as)[kk * TP + q] = v;
          });
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kDepthChunk; ++kk) {
        T av[4], bv[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          av[p] = as[kk * TP + ty + 16 * p];
          bv[p] = bs[kk * TP + tx + 16 * p];
        }
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][q] += av[p] * bv[q];
      }
    }
    // every old value read before any is written: the stores to w could
    // alias the loads from it, so the compiler would not hoist them
    T old[4][4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = r0 + ty + 16 * p, c = c0 + tx + 16 * q;
        old[p][q] = r < bw && c <= r && r + NB < bw ? window(w, r + NB, c + NB, off, bw) : T(0);
      }
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = r0 + ty + 16 * p, c = c0 + tx + 16 * q;
        if (r < bw && c <= r)
          w[(size_t)wrap(r + next, bw) * bw + wrap(c + next, bw)] = old[p][q] - acc[p][q];
      }
  }
}

// Into L2, the next step's band blocks: block 0 its diagonal block, every
// warp the rows below that it solves.
template <typename T, int NB>
__device__ void prefetch_step(const T* si, int bw) {
  constexpr int ROW_SECTORS = (NB * (int)sizeof(T) + 31) / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const char* base = reinterpret_cast<const char*>(si);
  if (blockIdx.x == 0)
    for (int q = threadIdx.x; q < NB * ROW_SECTORS; q += kThreads) prefetch_l2(base + 32 * q);
  for (int r = blockIdx.x * kWarps + warp; r < bw; r += gridDim.x * kWarps)
    for (int q = lane; q < ROW_SECTORS; q += 32)
      prefetch_l2(base + (size_t)(NB + r) * NB * sizeof(T) + 32 * q);
}

// s_blocks, out (m, NB + bw, NB); w (bw, bw) zero; flags [bad at any step,
// bad at this step] zero.
template <typename T, int NB>
__global__ void __launch_bounds__(kThreads)
    band_factor_kernel(const T* __restrict__ s_blocks, T* __restrict__ out, T* __restrict__ w,
                       int* __restrict__ flags, int m, int bw, T shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sm = reinterpret_cast<T*>(smem);
  cg::grid_group grid = cg::this_grid();
  const size_t step = (size_t)(NB + bw) * NB;
  int off = 0;
  for (int i = 0; i < m; ++i) {
    const T* si = s_blocks + i * step;
    T* oi = out + i * step;
    if (blockIdx.x == 0) factor_diagonal<T, NB>(si, oi, w, flags, off, bw, shift, sm);
    solve_below<T, NB>(si, oi, w, flags, off, bw, sm, [&] { grid.sync(); });
    if (i + 1 == m) break;
    prefetch_step<T, NB>(si + step, bw);
    grid.sync();
    schur_update<T, NB>(oi + (size_t)NB * NB, w, off, bw, sm);
    off = wrap(off + NB, bw);
    grid.sync();
  }
}

// The card's SM count and a kernel's blocks an SM at its shared memory.
template <typename K>
cudaError_t fit(K kernel, size_t smem, int* sms, int* per_sm) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, smem);
}

// The last launch's grid, blocks an SM that fit, SMs, shared memory and
// error, for the wrapper's error message.
struct Launch {
  int grid, per_sm, sms, smem, err;
};
Launch last_launch{0, 0, 0, 0, 0};

template <typename T>
struct Id {
  using type = T;
};

// One block an SM at most, and no more blocks than the work has: the grid
// must be co-resident, which the cooperative launch checks.
template <typename... A>
int launch(void (*kernel)(A...), int blocks, size_t smem, void* stream,
           typename Id<A>::type... params) {
  int sms = 0, per_sm = 0;
  cudaError_t err = fit(kernel, smem, &sms, &per_sm);
  const int grid = std::max(1, std::min(blocks, sms));
  last_launch = Launch{grid, per_sm, sms, (int)smem, (int)err};
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return last_launch.err = cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&params...};
  (void)cudaGetLastError();   // an earlier call's pending error is not this launch's
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), grid, kThreads, args, smem,
                                    static_cast<cudaStream_t>(stream));
  return last_launch.err = err;
}

template <typename P, typename T, int CT>
int launch_sweep(const void* dinv, const void* pbelow, const void* rhs, void* out, void* scratch,
                 int mp, int s, int bw, int c, int upper, void* stream) {
  constexpr int VS = Pad<CT>::value;
  constexpr int RT = ColTile<P>::value;
  const int kt = std::min(std::max(s, bw), kStageBytes / (VS * (int)sizeof(T)));
  const size_t smem = ((size_t)kt * VS + (size_t)kWarps * RT * CT) * sizeof(T);
  const int blocks = std::max((std::max(s, bw) + kWarps - 1) / kWarps, (s + RT - 1) / RT);
  return launch(panel_sweep_kernel<P, T, CT>, blocks, smem, stream,
                static_cast<const P*>(dinv), static_cast<const P*>(pbelow),
                static_cast<const T*>(rhs), static_cast<T*>(out), static_cast<T*>(scratch), mp,
                s, bw, c, upper, kt);
}

// Column tiles of 1, 4, 8 and 32 right-hand sides: the flow c1 solve's 1,
// the spectrum's 4, the smoothing's 3 or 6, the spectrum's purification's
// 32 a sweep (solvers/banded.py: band_solve_panels splits wider ones).
template <typename P, typename T>
int sweep(const void* dinv, const void* pbelow, const void* rhs, void* out, void* scratch,
          int mp, int s, int bw, int c, int upper, void* stream) {
  if (mp < 1 || s < 1 || bw < s || c < 1) return cudaErrorInvalidValue;
  if (c <= 1) return launch_sweep<P, T, 1>(dinv, pbelow, rhs, out, scratch, mp, s, bw, c, upper, stream);
  if (c <= 4) return launch_sweep<P, T, 4>(dinv, pbelow, rhs, out, scratch, mp, s, bw, c, upper, stream);
  if (c <= 8) return launch_sweep<P, T, 8>(dinv, pbelow, rhs, out, scratch, mp, s, bw, c, upper, stream);
  if (c <= 32) return launch_sweep<P, T, 32>(dinv, pbelow, rhs, out, scratch, mp, s, bw, c, upper, stream);
  return cudaErrorInvalidValue;
}

template <typename T, int NB>
int launch_factor(const void* s_blocks, void* out, void* w, void* flags, int m, int bw,
                  double shift, void* stream) {
  // ld and its reciprocals (phase 2); the Schur update's two staged tiles
  const size_t chol = (size_t)NB * (NB + 2), tiles = 2 * (size_t)kDepthChunk * (kTile + 1);
  const size_t smem = std::max(chol, tiles) * sizeof(T);
  const int nt = (bw + kTile - 1) / kTile;
  const int blocks = std::max(nt * (nt + 1) / 2, (bw + kWarps - 1) / kWarps);
  return launch(band_factor_kernel<T, NB>, blocks, smem, stream, static_cast<const T*>(s_blocks),
                static_cast<T*>(out), static_cast<T*>(w), static_cast<int*>(flags), m, bw,
                static_cast<T>(shift));
}

// nb 128, the block of every band layout the port builds
// (solvers/banded.py: build_band_pattern, solvers/mg.py: build_c1_band).
template <typename T>
int factor(const void* s_blocks, void* out, void* w, void* flags, int m, int nb, int bw,
           double shift, void* stream) {
  if (m < 1 || nb != 128 || bw < nb) return cudaErrorInvalidValue;
  return launch_factor<T, 128>(s_blocks, out, w, flags, m, bw, shift, stream);
}

// n grid-wide barriers and nothing else: what one costs the kernels above.
__global__ void __launch_bounds__(kThreads) grid_sync_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

}  // namespace

extern "C" {

#define BANDED_SWEEP_ENTRY(PTAG, TTAG, P, T)                                                  \
  int panel_sweep_##PTAG##_##TTAG(const void* dinv, const void* pbelow, const void* rhs,       \
                                  void* out, void* scratch, int mp, int s, int bw, int c,      \
                                  int upper, void* stream) {                                   \
    return sweep<P, T>(dinv, pbelow, rhs, out, scratch, mp, s, bw, c, upper, stream);          \
  }

// the panel and rhs types the port pairs: a factor's own type, and bfloat16
// panels (mg_c1_bf16) widened into either working type
BANDED_SWEEP_ENTRY(f32, f32, float, float)
BANDED_SWEEP_ENTRY(f64, f64, double, double)
BANDED_SWEEP_ENTRY(bf16, f32, __nv_bfloat16, float)
BANDED_SWEEP_ENTRY(bf16, f64, __nv_bfloat16, double)

int banded_last_launch(int* info) {
  info[0] = last_launch.grid;
  info[1] = last_launch.per_sm;
  info[2] = last_launch.sms;
  info[3] = last_launch.smem;
  info[4] = last_launch.err;
  return 0;
}

int band_factor_f32(const void* s_blocks, void* out, void* w, void* flags, int m, int nb, int bw,
                    double shift, void* stream) {
  return factor<float>(s_blocks, out, w, flags, m, nb, bw, shift, stream);
}

int band_factor_f64(const void* s_blocks, void* out, void* w, void* flags, int m, int nb, int bw,
                    double shift, void* stream) {
  return factor<double>(s_blocks, out, w, flags, m, nb, bw, shift, stream);
}

// A cooperative launch of `blocks` blocks (at most one an SM) meeting at n
// grid barriers; chip_smoke.py times it against n = 0.
int banded_grid_sync(int blocks, int n, void* stream) {
  return launch(grid_sync_kernel, blocks, 0, stream, n);
}

}  // extern "C"
