"""The march_field and march_whitney kernels against PR 13's design and
against each lever of their own design, on one NVIDIA GPU.

    python3 march_sweep.py

Builds the multigrid cell of ``chip_smoke.py`` phase 6 (the CLI defaults
on the cube's 24,576-triangle root: 393,216 triangles, 2048^2 textures,
float32, ten levels) and marches, with every case, the lanes the main path
gives the march kernels:

- "level trace": the 786,432 barycentre lanes at -1/2 and +1/2 along the
  last level's tfield (float32, budget max_steps x 16), and the same in
  float64 ("level trace f64", the goldens' form);
- "halfway": every texel lane of both 2048^2 textures (8,388,608);
- "whitney": the 393,216 barycentre lanes along the cell's Whitney
  coefficients expanded to signed half-edges (the composed tracker's
  march at this mesh, length 1/2).

CASES are kernels built from ``csrc/trace.cu`` by text replacement into
``meshopticalflow_tpu_torch/_build/`` (an edit to the kernel's text can
break a case: it raises naming the missing text): PR 13's design (a copy
of its kernel: one thread a lane, separate tables with an int64 opposite,
every division), the shipped kernel (one thread a lane, one 48-byte row a
crossing with the opposite triangle's metric, dead divisions skipped),
each lever alone on PR 13's structure, the shipped kernel with each lever
taken out or added (LEVERS: persistent warps with lane refill, no rows,
rows without the metric, evict-first lane I/O, every division, the skip's
test as branches, the row's map loaded after its opposite, division
slots shared by a warp's candidates), and at 64 and 256 threads a block.
Each case is checked lane for lane against the plain march (t and p bit
for bit, exhausted counts and lane-steps equal), then all are timed in
turns (ROUNDS rounds, every case once a round, CUDA events behind a
device sleep as ``chip_smoke.median_ms``). Prints a line per case and
writes ``chiprun_out/march_sweep.json``: µs per round and their median,
the byte bound and its share, lane-steps, warp-step slots and the SIMT
efficiency (lane-steps / slots). ``chip_smoke.py`` phase 7m builds the
"pr13" case (``case_library``) to time the shipped kernel against.
"""

from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
ROUNDS = 3

# PR 13's march kernel, as it was (its add_stats also adds the warp-step
# slots: 32 x the warp's longest lane).
PR13_KERNEL = r'''
namespace pr13 {

constexpr int kThreads = 128;
constexpr unsigned kFullWarp = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T ld(const T* p) { return __ldg(p); }

__device__ __forceinline__ int64_t ld(const int64_t* p) {
  return static_cast<int64_t>(__ldg(reinterpret_cast<const long long*>(p)));
}

// The mesh tables one step reads (kernels/tracing.py:TraceMesh), row-major.
template <typename T>
struct Tables {
  const T* g;           // (T, 4): the metric g00 g01 g10 g11
  const int64_t* opp;   // (3T,): opposite half-edge, -1 on the boundary
  const T* lin;         // (3T, 4): transition map into the opposite chart
  const T* cst;         // (3T, 2): its offset
  const T* field;       // (T, 2): per-triangle field, or the Whitney
                        // coefficients (3T,) with g_inv
  const T* g_inv;       // (T, 4): the inverse metric (Whitney form only)
};

// Largest positive ray-edge intersection (tracing.py:_edge_exit): the
// candidates in the plain order (bottom -> edge 2, left -> 1, diagonal ->
// 0), the larger s kept; idx -1 when no edge is hit.
template <typename T>
__device__ __forceinline__ void edge_candidate(T num, T den, T fp, T fv, int idx,
                                               int in_edge, T lo, T hi, T& best_s,
                                               int& best_idx) {
  if (den != T(0)) {
    const T s = num / den;
    const T foo = fp + fv * s;
    if (in_edge != idx && s > T(0) && foo >= lo && foo <= hi && s > best_s) {
      best_s = s;
      best_idx = idx;
    }
  }
}

template <typename T>
__device__ __forceinline__ void edge_exit(T px, T py, T vx, T vy, int in_edge, T lo, T hi,
                                          T& s, int& idx) {
  s = T(0);
  idx = -1;
  edge_candidate(-py, vy, px, vx, 2, in_edge, lo, hi, s, idx);
  edge_candidate(-px, vx, py, vy, 1, in_edge, lo, hi, s, idx);
  edge_candidate((T(1) - px) - py, vx + vy, px, vx, 0, in_edge, lo, hi, s, idx);
}

// a^T g b with g = [[g0, g1], [g1, g2]] (tracing.py:_metric_dot).
template <typename T>
__device__ __forceinline__ T metric_dot(T g0, T g1, T g2, T ax, T ay, T bx, T by) {
  return (ax * g0 + ay * g1) * bx + (ax * g1 + ay * g2) * by;
}

// The field at chart point (px, py) of triangle t (tracing.py:
// _Tables.field_at): the triangle's vector, or the Whitney field there.
template <typename T, bool kWhitney>
__device__ __forceinline__ void field_at(const Tables<T>& tb, int64_t t, T px, T py,
                                         T& vx, T& vy) {
  if (!kWhitney) {
    vx = ld(tb.field + 2 * t);
    vy = ld(tb.field + 2 * t + 1);
    return;
  }
  const T c0 = ld(tb.field + 3 * t), c1 = ld(tb.field + 3 * t + 1),
          c2 = ld(tb.field + 3 * t + 2);
  const T u = c2 * (T(1) - py) - py * (c1 + c0);
  const T w = px * (c0 + c2) - (T(1) - px) * c1;
  const T* l = tb.g_inv + 4 * t;
  vx = ld(l) * u + ld(l + 1) * w;
  vy = ld(l + 2) * u + ld(l + 3) * w;
}

// lin @ (x, y) (+ const) of half-edge e (tracing.py:_transform).
template <typename T>
__device__ __forceinline__ void transform(const Tables<T>& tb, int64_t e, T& px, T& py,
                                          T& vx, T& vy) {
  const T* l = tb.lin + 4 * e;
  const T l0 = ld(l), l1 = ld(l + 1), l2 = ld(l + 2), l3 = ld(l + 3);
  const T cpx = (l0 * px + l1 * py) + ld(tb.cst + 2 * e);
  const T cpy = (l2 * px + l3 * py) + ld(tb.cst + 2 * e + 1);
  const T cvx = l0 * vx + l1 * vy;
  const T cvy = l2 * vx + l3 * vy;
  px = cpx;
  py = cpy;
  vx = cvx;
  vy = cvy;
}

// One lane of FEM::RiemannianMesh::flow / whitneyFlow (tracing.py:
// _flow_init, then _flow_step until the lane stops or `budget` steps).
// Returns whether the lane is still live; `steps` counts its steps.
template <typename T, bool kWhitney>
__device__ bool march_lane(const Tables<T>& tb, int64_t& t, T& px, T& py, T flow_time,
                           T min_step, bool use_min_step, T lo, T hi, int64_t budget,
                           int64_t& steps) {
  const T direction = flow_time < T(0) ? T(-1) : T(1);
  T ft = fabs(flow_time);
  T vx, vy;
  field_at<T, kWhitney>(tb, t, px, py, vx, vy);
  vx = vx * direction;
  vy = vy * direction;
  T step_left = min_step;
  int in_edge = -1;
  bool active = vx * vx + vy * vy > T(0);
  steps = 0;
  while (active && steps < budget) {
    ++steps;
    bool live = vx * vx + vy * vy > T(0);
    T step;
    int idx;
    edge_exit(px, py, vx, vy, in_edge, lo, hi, step, idx);
    live = live && idx >= 0;
    const T* g = tb.g + 4 * t;
    const T g0 = ld(g), g1 = ld(g + 1), g2 = ld(g + 3);
    const T vgv = metric_dot(g0, g1, g2, vx, vy, vx, vy);
    const T sq_step = vgv * step * step;
    const bool update = use_min_step && sq_step > step_left * step_left;
    if (update) step = step_left / sqrt(vgv > T(0) ? vgv : T(1));
    const bool finish = ft < step;
    const T adv = finish ? ft : step;
    T npx = px + vx * adv;
    T npy = py + vy * adv;
    ft = ft - adv;
    live = live && !finish;
    if (live && update) {
      // re-read the field at the advanced point; stop on a reversal
      T fx, fy;
      field_at<T, kWhitney>(tb, t, npx, npy, fx, fy);
      const bool reversal = metric_dot(g0, g1, g2, vx, vy, fx, fy) * direction < T(0);
      vx = fx * direction;
      vy = fy * direction;
      step_left = min_step;
      in_edge = -1;
      live = !reversal;
    } else if (live) {
      // cross into the opposite triangle, or stop on the boundary
      const int64_t e = t * 3 + idx;
      const int64_t o = ld(tb.opp + e);
      if (o < 0) {
        live = false;
      } else {
        transform(tb, e, npx, npy, vx, vy);
        t = o / 3;
        in_edge = static_cast<int>(o % 3);
        step_left = step_left - sqrt(sq_step < T(0) ? T(0) : sq_step);
      }
    }
    px = npx;
    py = npy;
    active = live;
  }
  return active;
}

// Per-warp sums of the lanes' stats, one atomic each a warp; the
// warp-step slots (32 x the warp's longest lane) added for the sweep.
__device__ __forceinline__ void add_stats(bool exhausted, int64_t steps,
                                          unsigned long long* stats) {
  unsigned long long live = exhausted ? 1ull : 0ull;
  unsigned long long sum = static_cast<unsigned long long>(steps);
  unsigned long long top = sum;
  for (int off = 16; off > 0; off >>= 1) {
    live += __shfl_down_sync(kFullWarp, live, off);
    sum += __shfl_down_sync(kFullWarp, sum, off);
    const unsigned long long other = __shfl_down_sync(kFullWarp, top, off);
    top = other > top ? other : top;
  }
  if ((threadIdx.x & 31) == 0) {
    if (live) atomicAdd(stats, live);
    if (sum) atomicAdd(stats + 1, sum);
    if (top) atomicMax(stats + 2, top);
    if (top) atomicAdd(stats + 3, 32ull * top);
  }
}

// Lanes with t_in < 0 pass through unchanged (tracing.py:_finish).
// flow_time is per lane (ft_stride 1) or one value (ft_stride 0).
template <typename T, bool kWhitney>
__global__ void __launch_bounds__(kThreads)
march_kernel(Tables<T> tb, const int64_t* __restrict__ t_in, const T* __restrict__ p_in,
             const T* __restrict__ flow_time, int64_t ft_stride, int64_t n, T min_step,
             bool use_min_step, T lo, T hi, int64_t budget, int64_t* __restrict__ t_out,
             T* __restrict__ p_out, unsigned long long* __restrict__ stats) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  bool exhausted = false;
  int64_t steps = 0;
  if (i < n) {
    int64_t t = t_in[i];
    T px = p_in[2 * i], py = p_in[2 * i + 1];
    if (t >= 0) {
      exhausted = march_lane<T, kWhitney>(tb, t, px, py, flow_time[i * ft_stride], min_step,
                                          use_min_step, lo, hi, budget, steps);
    }
    t_out[i] = t;
    p_out[2 * i] = px;
    p_out[2 * i + 1] = py;
  }
  add_stats(exhausted, steps, stats);
}

inline unsigned grid_of(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace pr13

'''

# -- the texts of csrc/trace.cu that the levers replace ----------------------------
_LAUNCH_MARCH = "template <typename T, bool kWhitney>\nint launch_march("
_LAUNCH = ("    march_kernel<T, kWhitney><<<static_cast<unsigned>((n + kMarchThreads - 1) / "
           "kMarchThreads),\n                                kMarchThreads, 0, "
           "static_cast<cudaStream_t>(stream)>>>(\n")
_INIT = ("    const MarchTables<T> tb{static_cast<const Row<T>*>(rows), "
         "static_cast<const T*>(g),\n                            static_cast<const T*>(field), "
         "static_cast<const T*>(g_inv)};\n")
_ROW = "struct alignas(16) Row {\n  T v[sizeof(T) == 4 ? 12 : 10];\n};\n"
_CROSS_DECL = ("  __device__ __forceinline__ int cross(int e, T& px, T& py, T& vx, T& vy, T& g0,\n"
               "                                      T& g1, T& g2) const;\n")
_CROSS_F32 = '''template <>
__device__ __forceinline__ int MarchTables<float>::cross(int e, float& px, float& py,
                                                         float& vx, float& vy, float& g0,
                                                         float& g1, float& g2) const {
  const float4* r = reinterpret_cast<const float4*>(rows + e);
  const float4 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2);
  const int o = __float_as_int(c.y);
  keep_mapped(o, a.x, a.y, a.z, a.w, b.x, b.y, px, py, vx, vy);
  g0 = b.z;
  g1 = b.w;
  g2 = c.x;
  return o;
}
'''
_CROSS_F64 = '''template <>
__device__ __forceinline__ int MarchTables<double>::cross(int e, double& px, double& py,
                                                          double& vx, double& vy, double& g0,
                                                          double& g1, double& g2) const {
  const double2* r = reinterpret_cast<const double2*>(rows + e);
  const double2 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2), d = __ldg(r + 3),
                f = __ldg(r + 4);
  const int o = __double2loint(f.y);
  keep_mapped(o, a.x, a.y, b.x, b.y, c.x, c.y, px, py, vx, vy);
  g0 = d.x;
  g1 = d.y;
  g2 = f.x;
  return o;
}
'''
_SKIP = "  edge_exit<true>(s.px, s.py, vx, vy, s.in_edge, lo, hi, step, idx);\n"
_SKIP_TEST = ("  if (kSkip && !((in_edge != idx) & same_sign_bit(num, den) & (num != T(0)) &\n"
              "                 (den != T(0)))) {\n")
_KEEP_F32 = "  keep_mapped(o, a.x, a.y, a.z, a.w, b.x, b.y, px, py, vx, vy);\n"
_KEEP_F64 = "  keep_mapped(o, a.x, a.y, b.x, b.y, c.x, c.y, px, py, vx, vy);\n"
_LOAD = '''  t = t_in[k];
  px = p_in[2 * k];
  py = p_in[2 * k + 1];
  ft = flow_time[k * ft_stride];
'''
_STORE = '''  t_out[i] = t;
  p_out[2 * i] = px;
  p_out[2 * i + 1] = py;
'''
_THREADS = "constexpr int kMarchThreads = 128;"
_BEGIN_COMMENT = "// A lane's march state (tracing.py:_flow_init's dict), the triangle's\n"

# the refill design (persistent warps), marching with the shipped begin and
# step
_REFILL_KERNEL = r'''// Persistent warps with lane refill: about one resident grid of blocks; a
// warp takes lanes 32 at a time (its first chunk by its index, the later
// ones from ``counter``, asked for one chunk ahead), their starts
// loaded one a thread; a thread whose lane ends writes its end point and
// takes the chunk's next lane (ballot, popc, the start by shuffle). Blocks
// are whole warps (one warp of fewer threads is a warp of that width).
__device__ unsigned long long refill_counter;   // zeroed before each launch

template <typename T, bool kWhitney>
__global__ void __launch_bounds__(kMarchThreads)
refill_kernel(MarchTables<T> tb, const int64_t* __restrict__ t_in, const T* __restrict__ p_in,
             const T* __restrict__ flow_time, int64_t ft_stride, int64_t n, T min_step,
             bool use_min_step, T lo, T hi, int64_t budget, int64_t* __restrict__ t_out,
             T* __restrict__ p_out, unsigned long long* __restrict__ stats,
              unsigned long long* __restrict__ counter) {
  const int lane = threadIdx.x & 31;
  const int width = blockDim.x < kWarp ? static_cast<int>(blockDim.x) : kWarp;
  const unsigned below = (1u << lane) - 1u;
  const int64_t warps_per_block = (blockDim.x + kWarp - 1) / kWarp;
  const int64_t warps = gridDim.x * warps_per_block;
  // The warp's chunk: lanes [base, base + avail), lane base + k's start
  // held by thread k, ``next`` of them handed out. ``chunk`` is the next
  // chunk's index: the first one the warp's own, the later ones from the
  // counter, asked for one chunk ahead (lane 0's ``ticket``).
  int64_t chunk = blockIdx.x * warps_per_block + threadIdx.x / kWarp;
  unsigned long long ticket = 0;
  bool asked = false;
  int64_t base = 0;
  int avail = 0, next = 0;
  bool drained = false;
  int64_t pf_t = -1;
  T pf_px = T(0), pf_py = T(0), pf_ft = T(0);

  Lane<T> s;
  int64_t i = -1;               // this thread's lane, -1 while it holds none
  bool live = false;
  unsigned long long exhausted = 0, lane_steps = 0, top = 0, iters = 0;
  for (;;) {
    // hand the chunk's lanes to the threads that hold none
    for (;;) {
      const unsigned need = __ballot_sync(kFullWarp, i < 0);
      if (need == 0) break;
      if (next == avail) {
        if (drained) break;
        if (asked) chunk = warps + static_cast<int64_t>(__shfl_sync(kFullWarp, ticket, 0));
        base = chunk * width;
        if (base >= n) {
          drained = true;
          break;
        }
        avail = n - base < width ? static_cast<int>(n - base) : width;
        next = 0;
        if (lane < avail) {
          load_start(t_in, p_in, flow_time, ft_stride, base + lane, pf_t, pf_px, pf_py, pf_ft);
        }
        if (lane == 0) ticket = atomicAdd(counter, 1ull);
        asked = true;
      }
      const int src = next + __popc(need & below);
      const int slot = src < avail ? src : 0;
      const int64_t t0 = __shfl_sync(kFullWarp, pf_t, slot);
      const T px0 = __shfl_sync(kFullWarp, pf_px, slot);
      const T py0 = __shfl_sync(kFullWarp, pf_py, slot);
      const T ft0 = __shfl_sync(kFullWarp, pf_ft, slot);
      if (i < 0 && src < avail) {
        i = base + src;
        if (t0 < 0) {
          store_end(t_out, p_out, i, t0, px0, py0);
          i = -1;
        } else {
          live = march_begin<T, kWhitney>(tb, s, static_cast<int>(t0), px0, py0, ft0,
                                          min_step);
          if (!live || budget <= 0) {
            store_end(t_out, p_out, i, static_cast<int64_t>(s.t), s.px, s.py);
            exhausted += live ? 1ull : 0ull;
            i = -1;
          }
        }
      }
      const int taken = next + __popc(need);
      next = taken < avail ? taken : avail;
    }
    if (__ballot_sync(kFullWarp, i >= 0) == 0) break;
    ++iters;
    if (i >= 0) {
      live = march_step<T, kWhitney>(tb, s, min_step, use_min_step, lo, hi);
      if (!live || s.steps >= budget) {
        store_end(t_out, p_out, i, static_cast<int64_t>(s.t), s.px, s.py);
        exhausted += live ? 1ull : 0ull;
        lane_steps += static_cast<unsigned long long>(s.steps);
        top = static_cast<unsigned long long>(s.steps) > top
                  ? static_cast<unsigned long long>(s.steps) : top;
        i = -1;
      }
    }
  }
  add_stats(exhausted, lane_steps, top, iters, stats);
}

// About one resident grid of refill_kernel blocks on the current device,
// no more blocks than the lanes fill.
template <typename T, bool kWhitney>
unsigned refill_grid(int64_t n) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, refill_kernel<T, kWhitney>,
                                                kMarchThreads, 0);
  const int64_t resident = static_cast<int64_t>(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  const int64_t blocks = (n + kMarchThreads - 1) / kMarchThreads;
  return static_cast<unsigned>(blocks < resident ? blocks : resident);
}

'''
# the tables a crossing reads as PR 13 kept them: the opposite (int64),
# transition map and offset in three arrays, the next metric from g
_SPLIT_CROSS = '''  const int64_t* opp;
  const T* lin;
  const T* cst;

  __device__ __forceinline__ int cross(int e, T& px, T& py, T& vx, T& vy, T& g0, T& g1,
                                      T& g2) const {
    const int64_t o = ld(opp + e);
    const T* l = lin + 4 * static_cast<int64_t>(e);
    const T* c = cst + 2 * static_cast<int64_t>(e);
    keep_mapped(static_cast<int>(o), ld(l), ld(l + 1), ld(l + 2), ld(l + 3), ld(c), ld(c + 1),
                px, py, vx, vy);
    if (o >= 0) metric(static_cast<int>(o / 3), g0, g1, g2);
    return static_cast<int>(o);
  }
'''
_SPLIT_INIT = ("    const MarchTables<T> tb{static_cast<const Row<T>*>(rows), "
               "static_cast<const T*>(g),\n                            "
               "static_cast<const T*>(field), static_cast<const T*>(g_inv),\n"
               "                            static_cast<const int64_t*>(opp),\n"
               "                            static_cast<const T*>(lin), "
               "static_cast<const T*>(cst)};\n")
# rows without the opposite triangle's metric (unfolded_rows): l0-l3 | c0 c1
# opp - (32 B) in float32, l0 l1 | l2 l3 | c0 c1 | opp - (64 B) in float64;
# the next metric read from g after the row
_UNFOLDED_ROW = "struct alignas(8 * sizeof(T)) Row {\n  T v[8];\n};\n"
_UNFOLDED_F32 = '''template <>
__device__ __forceinline__ int MarchTables<float>::cross(int e, float& px, float& py,
                                                         float& vx, float& vy, float& g0,
                                                         float& g1, float& g2) const {
  const float4* r = reinterpret_cast<const float4*>(rows + e);
  const float4 a = __ldg(r), b = __ldg(r + 1);
  const int o = __float_as_int(b.z);
  keep_mapped(o, a.x, a.y, a.z, a.w, b.x, b.y, px, py, vx, vy);
  if (o >= 0) metric(o / 3, g0, g1, g2);
  return o;
}
'''
_UNFOLDED_F64 = '''template <>
__device__ __forceinline__ int MarchTables<double>::cross(int e, double& px, double& py,
                                                          double& vx, double& vy, double& g0,
                                                          double& g1, double& g2) const {
  const double2* r = reinterpret_cast<const double2*>(rows + e);
  const double2 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2);
  const int o = __ldg(reinterpret_cast<const int*>(r + 3));
  keep_mapped(o, a.x, a.y, b.x, b.y, c.x, c.y, px, py, vx, vy);
  if (o >= 0) metric(o / 3, g0, g1, g2);
  return o;
}
'''
# the lanes' starts and end points with the evict-first hints
_STREAMING_LOAD = '''  t = __ldcs(reinterpret_cast<const long long*>(t_in) + k);
  const typename Vec2<T>::type p =
      __ldcs(reinterpret_cast<const typename Vec2<T>::type*>(p_in) + k);
  px = p.x;
  py = p.y;
  ft = __ldcs(flow_time + k * ft_stride);
'''
_STREAMING_STORE = '''  typename Vec2<T>::type p;
  p.x = px;
  p.y = py;
  __stcs(reinterpret_cast<long long*>(t_out) + i, static_cast<long long>(t));
  __stcs(reinterpret_cast<typename Vec2<T>::type*>(p_out) + i, p);
'''
_PR13_LAUNCH = '''    const pr13::Tables<T> tb13{static_cast<const T*>(g), static_cast<const int64_t*>(opp),
                               static_cast<const T*>(lin), static_cast<const T*>(cst),
                               static_cast<const T*>(field), static_cast<const T*>(g_inv)};
    pr13::march_kernel<T, kWhitney><<<pr13::grid_of(n), pr13::kThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
        tb13, static_cast<const int64_t*>(t_in), static_cast<const T*>(p_in),
        static_cast<const T*>(flow_time), ft_stride, n, step_t, min_step > 0.0, lo, hi,
        budget, static_cast<int64_t*>(t_out), static_cast<T*>(p_out),
        static_cast<unsigned long long*>(stats));
  }
  return static_cast<int>(cudaGetLastError());
}
'''
_SHIPPED_LAUNCH_TAIL = '''    march_kernel<T, kWhitney><<<static_cast<unsigned>((n + kMarchThreads - 1) / kMarchThreads),
                                kMarchThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        tb, static_cast<const int64_t*>(t_in), static_cast<const T*>(p_in),
        static_cast<const T*>(flow_time), ft_stride, n, step_t, min_step > 0.0, lo, hi,
        budget, static_cast<int64_t*>(t_out), static_cast<T*>(p_out),
        static_cast<unsigned long long*>(stats));
  }
  return static_cast<int>(cudaGetLastError());
}
'''

_REFILL_LAUNCH = '''    unsigned long long* counter = nullptr;
    cudaGetSymbolAddress(reinterpret_cast<void**>(&counter), refill_counter);
    cudaMemsetAsync(counter, 0, sizeof(*counter), static_cast<cudaStream_t>(stream));
    refill_kernel<T, kWhitney><<<refill_grid<T, kWhitney>(n), kMarchThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        tb, static_cast<const int64_t*>(t_in), static_cast<const T*>(p_in),
        static_cast<const T*>(flow_time), ft_stride, n, step_t, min_step > 0.0, lo, hi,
        budget, static_cast<int64_t*>(t_out), static_cast<T*>(p_out),
        static_cast<unsigned long long*>(stats), counter);
  }
  return static_cast<int>(cudaGetLastError());
}
'''

# The candidates of the edge exit that need a division, in the plain order,
# moved into at most three slots (two unless the point lies a rounding
# outside its triangle), so a warp runs one division sequence a slot that
# some thread fills instead of one a candidate.
_SLOTS = r'''template <typename T>
__device__ __forceinline__ bool needs_division(T num, T den, int idx, int in_edge) {
  return in_edge != idx && ((num > T(0) && den > T(0)) || (num < T(0) && den < T(0)));
}

template <typename T>
__device__ __forceinline__ void edge_exit_slots(T px, T py, T vx, T vy, int in_edge, T lo,
                                                T hi, T& s, int& idx) {
  const T n2 = -py, n1 = -px, n0 = (T(1) - px) - py, d0 = vx + vy;
  const bool a2 = needs_division(n2, vy, 2, in_edge), a1 = needs_division(n1, vx, 1, in_edge),
             a0 = needs_division(n0, d0, 0, in_edge);
  // slot k: (num, den, fp, fv, idx); candidate 2 -> slot 0, 1 -> 0 or 1,
  // 0 -> 0, 1 or 2
  T sn0 = n2, sd0 = vy, sp0 = px, sv0 = vx;
  int si0 = a2 ? 2 : -1;
  T sn1 = n1, sd1 = vx, sp1 = py, sv1 = vy;
  int si1 = -1;
  if (a1) {
    if (si0 < 0) {
      sn0 = n1; sd0 = vx; sp0 = py; sv0 = vy; si0 = 1;
    } else {
      si1 = 1;
    }
  }
  T sn2 = n0, sd2 = d0;
  int si2 = -1;
  if (a0) {
    if (si0 < 0) {
      sn0 = n0; sd0 = d0; sp0 = px; sv0 = vx; si0 = 0;
    } else if (si1 < 0) {
      sn1 = n0; sd1 = d0; sp1 = px; sv1 = vx; si1 = 0;
    } else {
      si2 = 0;
    }
  }
  s = T(0);
  idx = -1;
  if (si0 >= 0) edge_candidate<false>(sn0, sd0, sp0, sv0, si0, in_edge, lo, hi, s, idx);
  if (si1 >= 0) edge_candidate<false>(sn1, sd1, sp1, sv1, si1, in_edge, lo, hi, s, idx);
  if (si2 >= 0) edge_candidate<false>(sn2, sd2, px, vx, si2, in_edge, lo, hi, s, idx);
}

'''

# lever -> (old, new) text replacements of csrc/trace.cu
LEVERS = {
    # PR 13's kernel, as it was
    "pr13": [(_LAUNCH_MARCH, PR13_KERNEL + _LAUNCH_MARCH),
             (_SHIPPED_LAUNCH_TAIL, _PR13_LAUNCH)],
    # persistent warps with lane refill
    "refill": [(_LAUNCH_MARCH, _REFILL_KERNEL + _LAUNCH_MARCH),
               (_SHIPPED_LAUNCH_TAIL, _REFILL_LAUNCH)],
    # no rows: the opposite (int64), map and offset in their own arrays
    "split": [(_CROSS_DECL, _SPLIT_CROSS), (_CROSS_F32, ""), (_CROSS_F64, ""),
              (_INIT, _SPLIT_INIT)],
    # rows without the opposite triangle's metric: two fetches a crossing
    "unfolded": [(_ROW, _UNFOLDED_ROW), (_CROSS_F32, _UNFOLDED_F32),
                 (_CROSS_F64, _UNFOLDED_F64)],
    # the lane I/O with the evict-first hints
    "streaming": [(_LOAD, _STREAMING_LOAD), (_STORE, _STREAMING_STORE)],
    # every edge candidate's division
    "every_division": [(_SKIP, _SKIP.replace("<true>", "<false>"))],
    # the skip's test as short-circuit comparisons (branches)
    "branch_skip": [(_SKIP_TEST, "  if (kSkip && !(in_edge != idx && ((num > T(0) && "
                                 "den > T(0)) ||\n                                    "
                                 "(num < T(0) && den < T(0))))) {\n")],
    # the map applied under the opposite's test, so the compiler loads the
    # row's map after its opposite
    "sunk_loads": [(_KEEP_F32, "  if (o >= 0) apply_map(a.x, a.y, a.z, a.w, b.x, b.y, px, py, "
                               "vx, vy);\n"),
                   (_KEEP_F64, "  if (o >= 0) apply_map(a.x, a.y, b.x, b.y, c.x, c.y, px, py, "
                               "vx, vy);\n")],
    # at most three division slots a step in place of one a candidate
    "division_slots": [(_BEGIN_COMMENT, _SLOTS + _BEGIN_COMMENT),
                       (_SKIP, _SKIP.replace("edge_exit<true>", "edge_exit_slots"))],
    "threads_64": [(_THREADS, _THREADS.replace("128", "64"))],
    "threads_256": [(_THREADS, _THREADS.replace("128", "256"))],
}
# case -> levers; "shipped" is csrc/trace.cu as it is (one thread a lane,
# rows with the opposite's metric, dead divisions skipped, plain lane I/O)
CASES = {
    "pr13": ("pr13",),
    "pr13_restructured": ("split", "every_division"),
    "refill_only": ("refill", "split", "every_division"),
    "rows_only": ("unfolded", "every_division"),
    "rows_folded": ("every_division",),
    "streaming_only": ("streaming", "split", "every_division"),
    "skip_division_only": ("split",),
    "division_slots_only": ("division_slots", "split"),
    "shipped_64": ("threads_64",),
    "shipped": (),
    "shipped_256": ("threads_256",),
    "shipped_refill": ("refill",),
    "shipped_unfolded": ("unfolded",),
    "shipped_streaming": ("streaming",),
    "shipped_no_skip": ("every_division",),
    "shipped_branch_skip": ("branch_skip",),
    "shipped_sunk_loads": ("sunk_loads",),
    "shipped_division_slots": ("division_slots",),
}


def case_source(levers) -> str:
    """csrc/trace.cu with the levers' replacements."""
    sys.path.insert(0, REPO)
    from meshopticalflow_tpu_torch.kernels import build

    src = (build.CSRC / "trace.cu").read_text()
    for lever in levers:
        for old, new in LEVERS[lever]:
            if src.count(old) != 1:
                raise RuntimeError(f"march lever {lever}: {old[:60]!r} is not in "
                                   "csrc/trace.cu once")
            src = src.replace(old, new)
    return src


def case_library(name: str):
    """CASES[name] as a library with the march library's flags and
    bindings; "shipped" is kernels/tracing.py:LIBRARY itself."""
    sys.path.insert(0, REPO)
    from meshopticalflow_tpu_torch.kernels import build, tracing

    if not CASES[name]:
        return tracing.LIBRARY
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = build.BUILD_DIR / f"trace_{name}.cu"
    path.write_text(case_source(CASES[name]))
    return build.CudaLibrary(f"trace_{name}", str(path), tracing._bind,
                             flags=tracing.LIBRARY.flags)


def unfolded_rows(tm):
    """The rows of the "unfolded" lever: tracing.march_rows' row without the
    opposite triangle's metric, 32 bytes in float32, 64 in float64."""
    import torch

    rows = torch.zeros((tm.opp.shape[0], 8), dtype=tm.g.dtype, device=tm.opp.device)
    rows[:, 0:4] = tm.xform_linear.reshape(-1, 4)
    rows[:, 4:6] = tm.xform_const.reshape(-1, 2)
    rows.view(torch.int32)[:, 6 if tm.g.dtype == torch.float32 else 12] = tm.opp.to(torch.int32)
    return rows


def _shapes(prob):
    """The main path's march inputs at the multigrid cell: (label, mesh,
    kernel, args of tracing.march, plain march, bytes of the bound)."""
    import numpy as np
    import torch

    import chip_smoke as smoke
    from meshopticalflow_tpu_torch.flow.pipeline import _halfway_lanes
    from meshopticalflow_tpu_torch.kernels import advect, tracing
    from meshopticalflow_tpu_torch.models.whitney import edge_reduction

    cfg, tm, tfield = prob.config, prob.arrays.tm, prob.tfield
    dev, dtype = tfield.device, tfield.dtype
    min_step, max_steps = cfg.flow_min_step, cfg.flow_max_steps
    budget = max_steps * smoke.MARCH_ESCALATE
    t_count = tm.n_triangles
    t0 = torch.arange(t_count, device=dev).repeat(2)
    p0 = torch.full((2 * t_count, 2), 1.0 / 3.0, dtype=dtype, device=dev)
    times = torch.cat([torch.full((t_count,), -0.5, dtype=dtype, device=dev),
                       torch.full((t_count,), 0.5, dtype=dtype, device=dev)])
    tm64 = tracing.make_trace_mesh(prob.mesh, torch.float64, dev)
    t2, p2, times2 = _halfway_lanes(prob._advect_src_t, prob._advect_src_p, -0.5, 0.5)
    red, sign, _ = edge_reduction(prob.mesh.opp)
    ce = torch.as_tensor(prob.coeffs.double().cpu().numpy()[red] * sign).to(dev, dtype)
    tw = torch.arange(t_count, device=dev)
    pw = torch.full((t_count, 2), 1.0 / 3.0, dtype=dtype, device=dev)

    def field(label, tmx, fld, tt, t_in, p_in):
        elem = fld.element_size()
        return (label, tmx, "march_field",
                dict(flow_time=tt, t_idx=t_in, p=p_in, min_step=min_step, budget=budget,
                     vfield=fld),
                lambda: advect.flow_field_trace_compacted_plain(tmx, fld, tt, t_in, p_in,
                                                                min_step, max_steps),
                lambda steps: smoke._march_bytes("march_field", tmx, t_in.shape[0], 3, elem,
                                                 2 * tmx.n_triangles, steps))

    return [field("level trace", tm, tfield, times, t0, p0),
            field("halfway", tm, tfield, times2, t2, p2),
            ("whitney", tm, "march_whitney",
             dict(flow_time=0.5, t_idx=tw, p=pw, min_step=min_step, budget=max_steps, ce=ce),
             lambda: tracing.whitney_flow_trace_plain(tm, ce, 0.5, tw, pw, min_step, max_steps,
                                                      with_diagnostics=True),
             lambda steps: smoke._march_bytes("march_whitney", tm, t_count, 2, 4,
                                              3 * t_count, steps)),
            field("level trace f64", tm64, tfield.double(), times.double(), t0, p0.double())]


def multigrid_cell():
    """phase 6's multigrid problem after its ten levels and its halfway."""
    import dataclasses

    import chip_smoke as smoke
    from meshopticalflow_tpu_torch.apps.optical_flow import build_parser, config_from_args
    from meshopticalflow_tpu_torch.flow.pipeline import FlowProblem

    os.makedirs(smoke.WORK, exist_ok=True)
    paths, _ = smoke.upsampled_inputs()
    root = smoke.write_mg_root()
    cfg = dataclasses.replace(config_from_args(build_parser().parse_args(
        ["--mesh", root, "--in", *paths, "--out", "unused.png"])), artifact_cache=False)
    prob = FlowProblem.from_texture_inputs(root, tuple(paths), cfg, device=smoke.DEVICE)
    prob.run()
    prob.halfway_texture()
    return prob


def sweep(libraries: dict, prob, rounds: int = ROUNDS) -> list:
    """Every case at every shape: held to the plain march, then timed in
    turns. Returns one record per (shape, case)."""
    import numpy as np
    import torch

    import chip_smoke as smoke
    from meshopticalflow_tpu_torch.kernels import tracing

    shipped = tracing.LIBRARY
    out = []
    for label, tm, kernel, args, plain, bytes_of in _shapes(prob):
        rows = {"shipped": tracing.march_rows(tm), "unfolded": unfolded_rows(tm)}
        ref = plain()
        torch.cuda.synchronize()

        def use(name):
            tracing.LIBRARY = libraries[name]
            tm.__dict__["_march_rows"] = rows["unfolded" if "unfolded" in CASES[name] else
                                              "shipped"]

        def launch():
            return tracing.march(tm, **args)

        recs = {}
        try:
            for name in CASES:
                use(name)
                t1, p1, _ = launch()
                st = tracing.last_stats(kernel)
                differ = int(((t1 != ref[0]) | (p1 != ref[1]).any(dim=1)).sum())
                if differ or st["exhausted"] != ref[2]:
                    raise RuntimeError(f"{name} at {label}: {differ} lanes differ from the "
                                       f"plain march; exhausted {st['exhausted']} against "
                                       f"{ref[2]}")
                flops = smoke.MARCH_OPS_PER_STEP[kernel] * st["lane_steps"]
                b_ms, b_by = smoke.bound(bytes_of(st["lane_steps"]), flops,
                                         "float64" if "f64" in label else "float32")
                recs[name] = dict(shape=label, case=name, levers=list(CASES[name]),
                                  kernel=kernel, lanes=st["lanes"],
                                  lane_steps=st["lane_steps"],
                                  max_lane_steps=st["max_lane_steps"],
                                  warp_slots=st["warp_slots"],
                                  simt_efficiency=st["lane_steps"] / max(st["warp_slots"], 1),
                                  bound_ms=b_ms, bound_by=b_by, ms_rounds=[])
            steps = {r["lane_steps"] for r in recs.values()}
            if len(steps) != 1:
                raise RuntimeError(f"{label}: the cases' lane-steps differ: {steps}")
            for _ in range(rounds):
                for name in CASES:
                    use(name)
                    recs[name]["ms_rounds"].append(smoke.median_ms(launch, reps=10, inner=2))
        finally:
            tracing.LIBRARY = shipped
            tm.__dict__["_march_rows"] = rows["shipped"]
        base = float(np.median(recs["pr13"]["ms_rounds"]))
        for name, r in recs.items():
            r["ms"] = float(np.median(r["ms_rounds"]))
            r["bound_share"] = r["bound_ms"] / r["ms"]
            r["pr13_over_case"] = base / r["ms"]
            print(f"{label:16s} {name:22s} {r['ms'] * 1e3:9.2f} us "
                  f"[{min(r['ms_rounds']) * 1e3:.2f}-{max(r['ms_rounds']) * 1e3:.2f}]  "
                  f"bound {r['bound_ms'] * 1e3:7.2f} us share {r['bound_share']:.3f}  "
                  f"simt {r['simt_efficiency']:.3f}  x{r['pr13_over_case']:.2f} of pr13",
                  flush=True)
            out.append(r)
        torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("march_sweep: torch.cuda.is_available() is false")
    sys.path.insert(0, REPO)
    import chip_smoke as smoke
    from meshopticalflow_tpu_torch import native
    from meshopticalflow_tpu_torch.kernels import build, spmv

    card = smoke.card_line()
    print(card, flush=True)
    libraries = {name: case_library(name) for name in CASES}
    build.build_all([spmv.LIBRARY, *libraries.values()])
    native.build()
    prob = multigrid_cell()
    records = sweep(libraries, prob)
    path = os.path.join(os.path.dirname(smoke.WORK), "march_sweep.json")
    with open(path, "w") as f:
        json.dump(dict(card=card, rounds=ROUNDS, cases=records), f, indent=1)
    print(f"wrote {os.path.relpath(path, REPO)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
