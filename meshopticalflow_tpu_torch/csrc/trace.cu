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
// Bound: a lane reads its start (t, p, flow time) and writes its end point
// once; a step reads the triangle's metric (3 values) and, only where it
// crosses an edge, the half-edge's opposite, transition map (4 values) and
// offset (2 values), or, where it re-reads the field, the field (2 values,
// or the Whitney form's 3 coefficients and inverse metric). Those bytes
// take some tens of µs at the main path's 786,432 lanes. What holds a march
// back is not bytes but issue: every step is some 150 instructions of IEEE
// arithmetic (three edge candidates, each a division with its slow-path
// check; a square root and a division where the field is re-read; a square
// root at a crossing), in a chain of dependent table reads (each step's
// triangle is the last step's crossing). Lanes start sorted by triangle, so
// a warp's lanes run alike: 0.835 of a warp's step slots carry a live lane
// on the main path.
//
// march_kernel's design (march_sweep.py times it against PR 13's design
// and against each lever, on the main path's lanes):
//   * one thread a lane, its state and its triangle's metric in registers,
//     128 threads a block (64 and 256 are slower);
//   * one row a crossing: a half-edge's transition map, offset, the
//     opposite triangle's metric g00 g01 g11 and the opposite (int32) in one
//     48-byte row (80 in float64; kernels/tracing.py:march_rows, packed once
//     a mesh), all its loads issued together, so a crossing is one round
//     trip where PR 13's design made three (the opposite, then the map and
//     offset, then the next step's metric);
//   * no division whose quotient cannot be kept: an edge candidate that is
//     rejected whatever its quotient (the entry edge; numerator and
//     denominator of other signs or either zero: s <= 0 or NaN) skips its
//     division, tested without branches.
// Persistent warps that refill a thread with the next lane when its lane
// ends, the lanes' I/O with evict-first hints, and division slots shared
// by a warp's candidates did not pay; they live in march_sweep.py as
// ablations. exp_kernel is PR 13's design: one thread a lane, the tables
// through __ldg.
//
// Every step is the plain version's arithmetic (kernels/tracing.py:
// _edge_exit, _metric_dot, _transform, _flow_step, exp_map) in its order of
// operations, with IEEE division and square root, and the library is built
// with -fmad=false (kernels/tracing.py: LIBRARY), so that no a * b + c is
// contracted into a fused multiply-add that the plain version's separate
// elementwise kernels do not make: end points equal the plain version's
// bit for bit.
//
// Each entry point also sums, over the lanes, into stats[0..3]: lanes still
// live when their budget ran out (the exhausted count), lane-steps, the
// largest lane's steps, and the warp-step slots (32 x the loop iterations
// each warp ran; lane-steps / slots is the SIMT efficiency), with warp
// shuffles and one atomic a warp. The caller zeroes stats. Each entry point
// launches on the given stream and returns cudaGetLastError(), which the
// Python wrapper checks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;         // exp_kernel
constexpr int kMarchThreads = 128;    // march_kernel
constexpr int kWarp = 32;
constexpr unsigned kFullWarp = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T ld(const T* p) { return __ldg(p); }

__device__ __forceinline__ int64_t ld(const int64_t* p) {
  return static_cast<int64_t>(__ldg(reinterpret_cast<const long long*>(p)));
}

template <typename T>
struct Vec2;
template <>
struct Vec2<float> { using type = float2; };
template <>
struct Vec2<double> { using type = double2; };

// The mesh tables of exp_kernel (kernels/tracing.py:TraceMesh), row-major.
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

__device__ __forceinline__ bool same_sign_bit(float a, float b) {
  return (__float_as_int(a) ^ __float_as_int(b)) >= 0;
}

__device__ __forceinline__ bool same_sign_bit(double a, double b) {
  return (__double_as_longlong(a) ^ __double_as_longlong(b)) >= 0;
}

// Largest positive ray-edge intersection (tracing.py:_edge_exit): the
// candidates in the plain order (bottom -> edge 2, left -> 1, diagonal ->
// 0), the larger s kept; idx -1 when no edge is hit. kSkip leaves out the
// division of a candidate that is rejected whatever its quotient: the
// entry edge, or num and den of other signs or either zero (s <= 0 or
// NaN); tested without branches.
template <bool kSkip, typename T>
__device__ __forceinline__ void edge_candidate(T num, T den, T fp, T fv, int idx,
                                               int in_edge, T lo, T hi, T& best_s,
                                               int& best_idx) {
  if (kSkip && !((in_edge != idx) & same_sign_bit(num, den) & (num != T(0)) &
                 (den != T(0)))) {
    return;
  }
  if (den != T(0)) {
    const T s = num / den;
    const T foo = fp + fv * s;
    if (in_edge != idx && s > T(0) && foo >= lo && foo <= hi && s > best_s) {
      best_s = s;
      best_idx = idx;
    }
  }
}

template <bool kSkip, typename T>
__device__ __forceinline__ void edge_exit(T px, T py, T vx, T vy, int in_edge, T lo, T hi,
                                          T& s, int& idx) {
  s = T(0);
  idx = -1;
  edge_candidate<kSkip>(-py, vy, px, vx, 2, in_edge, lo, hi, s, idx);
  edge_candidate<kSkip>(-px, vx, py, vy, 1, in_edge, lo, hi, s, idx);
  edge_candidate<kSkip>((T(1) - px) - py, vx + vy, px, vx, 0, in_edge, lo, hi, s, idx);
}

// a^T g b with g = [[g0, g1], [g1, g2]] (tracing.py:_metric_dot).
template <typename T>
__device__ __forceinline__ T metric_dot(T g0, T g1, T g2, T ax, T ay, T bx, T by) {
  return (ax * g0 + ay * g1) * bx + (ax * g1 + ay * g2) * by;
}

// (l0 l1; l2 l3) @ (x, y) (+ (c0, c1)) (tracing.py:_transform).
template <typename T>
__device__ __forceinline__ void apply_map(T l0, T l1, T l2, T l3, T c0, T c1, T& px, T& py,
                                          T& vx, T& vy) {
  const T cpx = (l0 * px + l1 * py) + c0;
  const T cpy = (l2 * px + l3 * py) + c1;
  const T cvx = l0 * vx + l1 * vy;
  const T cvy = l2 * vx + l3 * vy;
  px = cpx;
  py = cpy;
  vx = cvx;
  vy = cvy;
}

// apply_map where the opposite half-edge o is one (o >= 0); the map is
// computed whatever o, so a crossing's loads issue together.
template <typename T>
__device__ __forceinline__ void keep_mapped(int o, T l0, T l1, T l2, T l3, T c0, T c1, T& px,
                                            T& py, T& vx, T& vy) {
  T qx = px, qy = py, wx = vx, wy = vy;
  apply_map(l0, l1, l2, l3, c0, c1, qx, qy, wx, wy);
  if (o >= 0) {
    px = qx;
    py = qy;
    vx = wx;
    vy = wy;
  }
}

// lin @ (x, y) (+ const) of half-edge e from the split tables.
template <typename T>
__device__ __forceinline__ void transform(const Tables<T>& tb, int64_t e, T& px, T& py,
                                          T& vx, T& vy) {
  const T* l = tb.lin + 4 * e;
  apply_map(ld(l), ld(l + 1), ld(l + 2), ld(l + 3), ld(tb.cst + 2 * e), ld(tb.cst + 2 * e + 1),
            px, py, vx, vy);
}

// ---- march_kernel ----------------------------------------------------------

// One half-edge's row (kernels/tracing.py:march_rows): l0 l1 l2 l3, c0 c1,
// the opposite triangle's g00 g01 g11, then the opposite half-edge as int32
// in the next 4 bytes (48 bytes in float32, 80 in float64).
template <typename T>
struct alignas(16) Row {
  T v[sizeof(T) == 4 ? 12 : 10];
};

// What march_kernel reads: the rows, the metric (T, 4), and the field
// (T, 2) or the Whitney coefficients (3T,) with the inverse metric (T, 4).
template <typename T>
struct MarchTables {
  const Row<T>* rows;
  const T* g;
  const T* field;
  const T* g_inv;

  // g00, g01, g11 of triangle t
  __device__ __forceinline__ void metric(int t, T& g0, T& g1, T& g2) const {
    const typename Vec2<T>::type* m = reinterpret_cast<const typename Vec2<T>::type*>(g) + 2 * t;
    const typename Vec2<T>::type a = __ldg(m), b = __ldg(m + 1);
    g0 = a.x;
    g1 = a.y;
    g2 = b.y;
  }

  template <bool kWhitney>
  __device__ __forceinline__ void field_at(int t, T px, T py, T& vx, T& vy) const {
    if (!kWhitney) {
      const typename Vec2<T>::type f = __ldg(reinterpret_cast<const typename Vec2<T>::type*>(
          field) + t);
      vx = f.x;
      vy = f.y;
      return;
    }
    const T c0 = ld(field + 3 * t), c1 = ld(field + 3 * t + 1), c2 = ld(field + 3 * t + 2);
    const T u = c2 * (T(1) - py) - py * (c1 + c0);
    const T w = px * (c0 + c2) - (T(1) - px) * c1;
    const typename Vec2<T>::type* l =
        reinterpret_cast<const typename Vec2<T>::type*>(g_inv) + 2 * t;
    const typename Vec2<T>::type a = __ldg(l), b = __ldg(l + 1);
    vx = a.x * u + a.y * w;
    vy = b.x * u + b.y * w;
  }

  // Cross half-edge e: the opposite half-edge, and (when there is one) the
  // point and vector carried into its chart and its triangle's metric.
  __device__ __forceinline__ int cross(int e, T& px, T& py, T& vx, T& vy, T& g0,
                                      T& g1, T& g2) const;
};

template <>
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

template <>
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

// A lane's march state (tracing.py:_flow_init's dict), the triangle's
// metric with it.
template <typename T>
struct Lane {
  int t, in_edge;
  T px, py, vx, vy, ft, step_left, direction, g0, g1, g2;
  int64_t steps;
};

// tracing.py:_flow_init for one lane at triangle t >= 0; returns whether
// the lane is active (a nonzero field).
template <typename T, bool kWhitney>
__device__ __forceinline__ bool march_begin(const MarchTables<T>& tb, Lane<T>& s, int t, T px,
                                            T py, T flow_time, T min_step) {
  s.t = t;
  s.px = px;
  s.py = py;
  s.direction = flow_time < T(0) ? T(-1) : T(1);
  s.ft = fabs(flow_time);
  T vx, vy;
  tb.template field_at<kWhitney>(t, px, py, vx, vy);
  s.vx = vx * s.direction;
  s.vy = vy * s.direction;
  s.step_left = min_step;
  s.in_edge = -1;
  s.steps = 0;
  const bool active = s.vx * s.vx + s.vy * s.vy > T(0);
  if (active) tb.metric(t, s.g0, s.g1, s.g2);
  return active;
}

// One step of FEM::RiemannianMesh::flow / whitneyFlow (tracing.py:
// _flow_step) of a live lane; returns whether the lane is still live.
template <typename T, bool kWhitney>
__device__ __forceinline__ bool march_step(const MarchTables<T>& tb, Lane<T>& s, T min_step,
                                           bool use_min_step, T lo, T hi) {
  ++s.steps;
  const T vx = s.vx, vy = s.vy;
  bool live = vx * vx + vy * vy > T(0);
  T step;
  int idx;
  edge_exit<true>(s.px, s.py, vx, vy, s.in_edge, lo, hi, step, idx);
  live = live && idx >= 0;
  const T vgv = metric_dot(s.g0, s.g1, s.g2, vx, vy, vx, vy);
  const T sq_step = vgv * step * step;
  const bool update = use_min_step && sq_step > s.step_left * s.step_left;
  if (update) step = s.step_left / sqrt(vgv > T(0) ? vgv : T(1));
  const bool finish = s.ft < step;
  const T adv = finish ? s.ft : step;
  T npx = s.px + vx * adv;
  T npy = s.py + vy * adv;
  s.ft = s.ft - adv;
  live = live && !finish;
  if (live && update) {
    // re-read the field at the advanced point; stop on a reversal
    T fx, fy;
    tb.template field_at<kWhitney>(s.t, npx, npy, fx, fy);
    const bool reversal = metric_dot(s.g0, s.g1, s.g2, vx, vy, fx, fy) * s.direction < T(0);
    s.vx = fx * s.direction;
    s.vy = fy * s.direction;
    s.step_left = min_step;
    s.in_edge = -1;
    live = !reversal;
  } else if (live) {
    // cross into the opposite triangle, or stop on the boundary
    const int o = tb.cross(3 * s.t + idx, npx, npy, s.vx, s.vy, s.g0, s.g1, s.g2);
    if (o < 0) {
      live = false;
    } else {
      s.t = o / 3;
      s.in_edge = o - 3 * s.t;
      s.step_left = s.step_left - sqrt(sq_step < T(0) ? T(0) : sq_step);
    }
  }
  s.px = npx;
  s.py = npy;
  return live;
}

// Per-warp sums of the lanes' stats, one atomic each a warp: exhausted
// lanes, lane-steps, the largest lane's steps, and kWarp x the warp's loop
// iterations (``iters``: its largest value over the warp).
__device__ __forceinline__ void add_stats(unsigned long long exhausted,
                                          unsigned long long steps, unsigned long long top,
                                          unsigned long long iters,
                                          unsigned long long* stats) {
  for (int off = 16; off > 0; off >>= 1) {
    exhausted += __shfl_down_sync(kFullWarp, exhausted, off);
    steps += __shfl_down_sync(kFullWarp, steps, off);
    const unsigned long long other = __shfl_down_sync(kFullWarp, top, off);
    top = other > top ? other : top;
    const unsigned long long more = __shfl_down_sync(kFullWarp, iters, off);
    iters = more > iters ? more : iters;
  }
  if ((threadIdx.x & 31) == 0) {
    if (exhausted) atomicAdd(stats, exhausted);
    if (steps) atomicAdd(stats + 1, steps);
    if (top) atomicMax(stats + 2, top);
    if (iters) atomicAdd(stats + 3, kWarp * iters);
  }
}

// A lane's start and end point, read and written once.
template <typename T>
__device__ __forceinline__ void load_start(const int64_t* t_in, const T* p_in,
                                           const T* flow_time, int64_t ft_stride, int64_t k,
                                           int64_t& t, T& px, T& py, T& ft) {
  t = t_in[k];
  px = p_in[2 * k];
  py = p_in[2 * k + 1];
  ft = flow_time[k * ft_stride];
}

template <typename T>
__device__ __forceinline__ void store_end(int64_t* t_out, T* p_out, int64_t i, int64_t t, T px,
                                          T py) {
  t_out[i] = t;
  p_out[2 * i] = px;
  p_out[2 * i + 1] = py;
}

// One thread a lane, from its start to its end or budget. Lanes with
// t_in < 0 pass through unchanged (tracing.py:_finish). flow_time is per
// lane (ft_stride 1) or one value (ft_stride 0).
template <typename T, bool kWhitney>
__global__ void __launch_bounds__(kMarchThreads)
march_kernel(MarchTables<T> tb, const int64_t* __restrict__ t_in, const T* __restrict__ p_in,
             const T* __restrict__ flow_time, int64_t ft_stride, int64_t n, T min_step,
             bool use_min_step, T lo, T hi, int64_t budget, int64_t* __restrict__ t_out,
             T* __restrict__ p_out, unsigned long long* __restrict__ stats) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  unsigned long long exhausted = 0, steps = 0;
  if (i < n) {
    int64_t t;
    T px, py, ft;
    load_start(t_in, p_in, flow_time, ft_stride, i, t, px, py, ft);
    if (t >= 0) {
      Lane<T> s;
      bool live = march_begin<T, kWhitney>(tb, s, static_cast<int>(t), px, py, ft, min_step);
      while (live && s.steps < budget) {
        live = march_step<T, kWhitney>(tb, s, min_step, use_min_step, lo, hi);
      }
      exhausted = live ? 1ull : 0ull;
      steps = static_cast<unsigned long long>(s.steps);
      t = s.t;
      px = s.px;
      py = s.py;
    }
    store_end(t_out, p_out, i, t, px, py);
  }
  add_stats(exhausted, steps, steps, steps, stats);
}

// ---- exp_kernel (PR 13's design) -----------------------------------------

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
    edge_exit<false>(px, py, vx, vy, in_edge, lo, hi, s, idx);
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
  add_stats(exhausted ? 1ull : 0ull, static_cast<unsigned long long>(steps),
            static_cast<unsigned long long>(steps), static_cast<unsigned long long>(steps),
            stats);
}

inline unsigned grid_of(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

template <typename T, bool kWhitney>
int launch_march(const void* rows, const void* g, const void* opp, const void* lin,
                 const void* cst, const void* field, const void* g_inv, const void* t_in,
                 const void* p_in, const void* flow_time, int64_t ft_stride, int64_t n,
                 double min_step, double eps, int64_t budget, void* t_out, void* p_out,
                 void* stats, void* stream) {
  // opp, lin and cst (the split tables) are read only by march_sweep.py's
  // cases that keep PR 13's tables; the entry points keep one signature
  (void)opp;
  (void)lin;
  (void)cst;
  if (n > 0) {
    const MarchTables<T> tb{static_cast<const Row<T>*>(rows), static_cast<const T*>(g),
                            static_cast<const T*>(field), static_cast<const T*>(g_inv)};
    // the plain version's scalars, rounded to T as torch rounds them
    const T step_t = static_cast<T>(min_step);
    const T lo = static_cast<T>(-eps), hi = static_cast<T>(1.0 + eps);
    march_kernel<T, kWhitney><<<static_cast<unsigned>((n + kMarchThreads - 1) / kMarchThreads),
                                kMarchThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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

#define TRACE_MARCH_ENTRY(NAME, T, WHITNEY)                                                 \
  int NAME(const void* rows, const void* g, const void* opp, const void* lin,                \
           const void* cst, const void* field, const void* g_inv, const void* t_in,          \
           const void* p_in, const void* flow_time, int64_t ft_stride, int64_t n,            \
           double min_step, double eps, int64_t budget, void* t_out, void* p_out,            \
           void* stats, void* stream) {                                                      \
    return launch_march<T, WHITNEY>(rows, g, opp, lin, cst, field, g_inv, t_in, p_in,        \
                                    flow_time, ft_stride, n, min_step, eps, budget, t_out,   \
                                    p_out, stats, stream);                                   \
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
