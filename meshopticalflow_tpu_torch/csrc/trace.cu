// Geodesic march kernels for Hopper (sm_90a). The reference package runs
// every march as an XLA while_loop over all lanes at once, with no Pallas
// kernel (meshopticalflow_tpu/kernels/tracing.py):
//
//   march_field_{f32,f64}    <- flow_field_trace (:159), and
//                               kernels/advect.py:flow_field_trace_compacted (:244)
//                               march along a per-triangle field
//   march_whitney_{f32,f64}  <- whitney_flow_trace (:320)
//                               the same march along the Whitney field of
//                               signed half-edge coefficients
//   exp_map_{f32,f64}        <- exp_map (:623)
//                               straight-line geodesic of a displacement
//
// Design: one thread per lane, its whole state (triangle, point, vector,
// flow time left, arc length left to the next re-read, entry edge) in
// registers; the lane steps until it stops or spends its own budget of
// steps, then writes its end point. Lanes are independent, so nothing is
// ordered across the grid, and a march is one launch where the plain
// version (kernels/tracing.py) issues some 70 elementwise launches a step
// and reads a live-lane count back to the host every 32 steps.
//
// Bound: a lane reads its start (t, p, flow time) and writes its end point
// once; a step reads the triangle's metric (3 values) and, only where it
// crosses an edge, the half-edge's opposite (int64), transition map (4
// values) and offset (2 values), or, where it re-reads the field, the
// field (2 values, or the Whitney form's 3 coefficients and inverse
// metric). Those bytes, with the tables counted once, take some tens of µs
// at the main path's 786,432 lanes; the march's real time is the longest
// lanes' chains of dependent table reads (each step's triangle is the last
// step's crossing), which the tables' residence in the 50 MB L2 and the
// other warps' lanes hide as far as they can. The tables go through the
// read-only path (__ldg).
//
// Every step is the plain version's arithmetic (kernels/tracing.py:
// _edge_exit, _metric_dot, _transform, _flow_step, exp_map) in its order of
// operations, with IEEE division and square root, and the library is built
// with -fmad=false (kernels/tracing.py: LIBRARY), so that no a * b + c is
// contracted into a fused multiply-add that the plain version's separate
// elementwise kernels do not make: end points equal the plain version's
// bit for bit.
//
// Each entry point also sums, over the lanes, into stats[0..2]: lanes
// still live when their budget ran out (the exhausted count), lane-steps,
// and the largest lane's steps (warp shuffles, one atomic a warp). The
// caller zeroes stats. Each entry point launches on the given stream and
// returns cudaGetLastError(), which the Python wrapper checks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// One lane of FEM::RiemannianMesh::exp (tracing.py:exp_map): the pre-step
// off a chart edge, then straight steps carrying the remaining
// displacement across charts until it ends inside a triangle.
template <typename T>
__device__ bool exp_lane(const Tables<T>& tb, int64_t& t, T& px, T& py, T vx, T vy, T lo,
                         T hi, int64_t budget, int64_t& steps) {
  bool active = vx * vx + vy * vy > T(0);
  int in_edge = -1;
  int idx = -1;
  if (px <= T(0) && vx < T(0)) {
    idx = 1;
  } else if (py <= T(0) && vy < T(0)) {
    idx = 2;
  } else if (px + py >= T(1) && vx + vy > T(0)) {
    idx = 0;
  }
  if (active && idx != -1) {
    const int64_t e = t * 3 + idx;
    const int64_t o = ld(tb.opp + e);
    if (o >= 0) {
      transform(tb, e, px, py, vx, vy);
      t = o / 3;
      in_edge = static_cast<int>(o % 3);
    }
  }
  steps = 0;
  while (active && steps < budget) {
    ++steps;
    T s;
    edge_exit(px, py, vx, vy, in_edge, lo, hi, s, idx);
    const bool finish = s > T(1);
    T npx, npy, nvx, nvy;
    if (finish) {
      npx = px + vx;
      npy = py + vy;
      nvx = T(0);
      nvy = T(0);
    } else {
      npx = px + vx * s;
      npy = py + vy * s;
      const T rest = T(1) - s;
      nvx = vx * rest;
      nvy = vy * rest;
    }
    bool live = idx >= 0 && !finish;
    if (live) {
      const int64_t e = t * 3 + idx;
      const int64_t o = ld(tb.opp + e);
      if (o < 0) {
        live = false;
      } else {
        transform(tb, e, npx, npy, nvx, nvy);
        t = o / 3;
        in_edge = static_cast<int>(o % 3);
      }
    }
    px = npx;
    py = npy;
    vx = nvx;
    vy = nvy;
    active = live;
  }
  return active;
}

// Per-warp sums of the lanes' stats, one atomic each a warp.
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
exp_kernel(Tables<T> tb, const int64_t* __restrict__ t_in, const T* __restrict__ p_in,
           const T* __restrict__ v_in, int64_t n, T lo, T hi, int64_t budget,
           int64_t* __restrict__ t_out, T* __restrict__ p_out,
           unsigned long long* __restrict__ stats) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  bool exhausted = false;
  int64_t steps = 0;
  if (i < n) {
    int64_t t = t_in[i];
    T px = p_in[2 * i], py = p_in[2 * i + 1];
    if (t >= 0) {
      exhausted = exp_lane<T>(tb, t, px, py, v_in[2 * i], v_in[2 * i + 1], lo, hi, budget,
                              steps);
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

template <typename T, bool kWhitney>
int launch_march(const void* g, const void* opp, const void* lin, const void* cst,
                 const void* field, const void* g_inv, const void* t_in, const void* p_in,
                 const void* flow_time, int64_t ft_stride, int64_t n, double min_step,
                 double eps, int64_t budget, void* t_out, void* p_out, void* stats,
                 void* stream) {
  if (n > 0) {
    const Tables<T> tb{static_cast<const T*>(g), static_cast<const int64_t*>(opp),
                       static_cast<const T*>(lin), static_cast<const T*>(cst),
                       static_cast<const T*>(field), static_cast<const T*>(g_inv)};
    // the plain version's scalars, rounded to T as torch rounds them
    const T step_t = static_cast<T>(min_step);
    const T lo = static_cast<T>(-eps), hi = static_cast<T>(1.0 + eps);
    march_kernel<T, kWhitney><<<grid_of(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        tb, static_cast<const int64_t*>(t_in), static_cast<const T*>(p_in),
        static_cast<const T*>(flow_time), ft_stride, n, step_t, min_step > 0.0, lo, hi,
        budget, static_cast<int64_t*>(t_out), static_cast<T*>(p_out),
        static_cast<unsigned long long*>(stats));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_exp(const void* opp, const void* lin, const void* cst, const void* t_in,
               const void* p_in, const void* v_in, int64_t n, double eps, int64_t budget,
               void* t_out, void* p_out, void* stats, void* stream) {
  if (n > 0) {
    const Tables<T> tb{nullptr, static_cast<const int64_t*>(opp), static_cast<const T*>(lin),
                       static_cast<const T*>(cst), nullptr, nullptr};
    const T lo = static_cast<T>(-eps), hi = static_cast<T>(1.0 + eps);
    exp_kernel<T><<<grid_of(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        tb, static_cast<const int64_t*>(t_in), static_cast<const T*>(p_in),
        static_cast<const T*>(v_in), n, lo, hi, budget, static_cast<int64_t*>(t_out),
        static_cast<T*>(p_out), static_cast<unsigned long long*>(stats));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define TRACE_MARCH_ENTRY(NAME, T, WHITNEY)                                                \
  int NAME(const void* g, const void* opp, const void* lin, const void* cst,                \
           const void* field, const void* g_inv, const void* t_in, const void* p_in,        \
           const void* flow_time, int64_t ft_stride, int64_t n, double min_step,            \
           double eps, int64_t budget, void* t_out, void* p_out, void* stats,               \
           void* stream) {                                                                  \
    return launch_march<T, WHITNEY>(g, opp, lin, cst, field, g_inv, t_in, p_in, flow_time,  \
                                    ft_stride, n, min_step, eps, budget, t_out, p_out,      \
                                    stats, stream);                                         \
  }

TRACE_MARCH_ENTRY(march_field_f32, float, false)
TRACE_MARCH_ENTRY(march_field_f64, double, false)
TRACE_MARCH_ENTRY(march_whitney_f32, float, true)
TRACE_MARCH_ENTRY(march_whitney_f64, double, true)

int exp_map_f32(const void* opp, const void* lin, const void* cst, const void* t_in,
                const void* p_in, const void* v_in, int64_t n, double eps, int64_t budget,
                void* t_out, void* p_out, void* stats, void* stream) {
  return launch_exp<float>(opp, lin, cst, t_in, p_in, v_in, n, eps, budget, t_out, p_out,
                           stats, stream);
}

int exp_map_f64(const void* opp, const void* lin, const void* cst, const void* t_in,
                const void* p_in, const void* v_in, int64_t n, double eps, int64_t budget,
                void* t_out, void* p_out, void* stats, void* stream) {
  return launch_exp<double>(opp, lin, cst, t_in, p_in, v_in, n, eps, budget, t_out, p_out,
                            stats, stream);
}

}  // extern "C"
