// Native host-side preprocessing kernels.
//
// The reference implements its entire runtime in C++; in this rebuild the
// device compute path is JAX/XLA, and the host-side preprocessing that the
// reference runs in hot C++ loops lives here: the uv-atlas scanline
// rasterizer with seam dilation (Src/MeshFlow.inl:280-467) and directed
// half-edge pairing (Misha/FEM.inl:591-614). Compiled to a shared library
// at build/import time and bound via ctypes (meshopticalflow_tpu/native).
//
// Semantics mirror the numpy implementations exactly (geometry/rasterize.py,
// geometry/mesh.py), which serve as the test oracle and fallback.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Vec2 {
  double x, y;
};

inline void barycentric(const double* v /*3x2*/, double px, double py,
                        double* out) {
  const double w1x = v[2] - v[0], w1y = v[3] - v[1];
  const double w2x = v[4] - v[0], w2y = v[5] - v[1];
  double det = w1x * w2y - w1y * w2x;
  if (det == 0.0) det = 1e-300;
  const double dx = px - v[0], dy = py - v[1];
  out[0] = (dx * w2y - dy * w2x) / det;
  out[1] = (-dx * w1y + dy * w1x) / det;
}

}  // namespace

extern "C" {

// Directed half-edge pairing (FEM.inl:591-614). Edge index 3t + (v+2)%3
// carries the half-edge tri[t][v] -> tri[t][(v+1)%3]. Returns 0 on success,
// 1 if a directed half-edge is duplicated (non-manifold / inconsistent
// orientation).
int half_edge_opposites(const int32_t* tris, int64_t t_count, int32_t* opp) {
  std::unordered_map<uint64_t, int32_t> map;
  map.reserve(static_cast<size_t>(t_count) * 3 * 2);
  for (int64_t t = 0; t < t_count; ++t) {
    for (int v = 0; v < 3; ++v) {
      const uint64_t a = static_cast<uint32_t>(tris[3 * t + v]);
      const uint64_t b = static_cast<uint32_t>(tris[3 * t + (v + 1) % 3]);
      const uint64_t key = (a << 32) | b;
      const int32_t idx = static_cast<int32_t>(3 * t + (v + 2) % 3);
      auto ins = map.emplace(key, idx);
      if (!ins.second) return 1;
    }
  }
  for (int64_t t = 0; t < t_count; ++t) {
    for (int v = 0; v < 3; ++v) {
      const uint64_t a = static_cast<uint32_t>(tris[3 * t + v]);
      const uint64_t b = static_cast<uint32_t>(tris[3 * t + (v + 1) % 3]);
      const int32_t idx = static_cast<int32_t>(3 * t + (v + 2) % 3);
      auto it = map.find((b << 32) | a);
      opp[idx] = (it == map.end()) ? -1 : it->second;
    }
  }
  return 0;
}

// Scanline rasterization of uv triangles (MeshFlow.inl:280-337): first
// writer (lowest triangle index through in-order processing) wins; exact
// reference ceil/floor/clamp and zero-slope-row semantics. Followed by
// ``pad`` rounds of nearest-neighbor dilation with the reference neighbor
// priority (MeshFlow.inl:368-397). Outputs tri (-1 = unclaimed) and
// barycentric coordinates per texel (row-major, j*width + i, uv space).
void rasterize_texture_source(const double* uvs /*T*3*2*/, int64_t t_count,
                              int32_t width, int32_t height, int32_t pad,
                              int32_t* tri, double* bary) {
  const int64_t n = static_cast<int64_t>(width) * height;
  std::fill(tri, tri + n, -1);
  std::fill(bary, bary + 2 * n, 0.0);

  std::vector<double> v(6);
  for (int64_t t = 0; t < t_count; ++t) {
    for (int k = 0; k < 3; ++k) {
      v[2 * k] = uvs[6 * t + 2 * k] * (width - 1);
      v[2 * k + 1] = uvs[6 * t + 2 * k + 1] * (height - 1);
    }
    // Sort by y with the reference tie-breaks (MeshFlow.inl:285-305).
    int map[3];
    const double y0 = v[1], y1 = v[3], y2 = v[5];
    if (y0 <= y1 && y0 <= y2) {
      map[0] = 0;
      if (y1 <= y2) { map[1] = 1; map[2] = 2; } else { map[1] = 2; map[2] = 1; }
    } else if (y1 <= y0 && y1 <= y2) {
      map[0] = 1;
      if (y0 <= y2) { map[1] = 0; map[2] = 2; } else { map[1] = 2; map[2] = 0; }
    } else {
      map[0] = 2;
      if (y0 <= y1) { map[1] = 0; map[2] = 1; } else { map[1] = 1; map[2] = 0; }
    }
    const double w[3][2] = {{v[2 * map[0]], v[2 * map[0] + 1]},
                            {v[2 * map[1]], v[2 * map[1] + 1]},
                            {v[2 * map[2]], v[2 * map[2] + 1]}};
    int y_start = static_cast<int>(std::ceil(w[0][1]));
    int y_end = static_cast<int>(std::floor(w[2][1]));
    y_start = std::max(0, std::min(height - 1, y_start));
    y_end = std::max(0, std::min(height - 1, y_end));
    for (int y = y_start; y <= y_end; ++y) {
      double source[2], s0[2], s1[2];
      if (y >= w[1][1]) {
        source[0] = w[2][0]; source[1] = w[2][1];
        s0[0] = w[1][0] - w[2][0]; s0[1] = w[1][1] - w[2][1];
        s1[0] = w[0][0] - w[2][0]; s1[1] = w[0][1] - w[2][1];
      } else {
        source[0] = w[0][0]; source[1] = w[0][1];
        s0[0] = w[1][0] - w[0][0]; s0[1] = w[1][1] - w[0][1];
        s1[0] = w[2][0] - w[0][0]; s1[1] = w[2][1] - w[0][1];
      }
      if (s0[1] == 0.0 || s1[1] == 0.0) continue;
      const double xi0 = source[0] + (y - source[1]) * s0[0] / s0[1];
      const double xi1 = source[0] + (y - source[1]) * s1[0] / s1[1];
      int x_start, x_end;
      if (xi0 <= xi1) {
        x_start = static_cast<int>(std::ceil(xi0));
        x_end = static_cast<int>(std::floor(xi1));
      } else {
        x_start = static_cast<int>(std::ceil(xi1));
        x_end = static_cast<int>(std::floor(xi0));
      }
      x_start = std::max(0, std::min(width - 1, x_start));
      x_end = std::max(0, std::min(width - 1, x_end));
      for (int x = x_start; x <= x_end; ++x) {
        const int64_t idx = static_cast<int64_t>(y) * width + x;
        if (tri[idx] == -1) {
          double b[2];
          barycentric(v.data(), x, y, b);
          tri[idx] = static_cast<int32_t>(t);
          bary[2 * idx] = b[0];
          bary[2 * idx + 1] = b[1];
        }
      }
    }
  }

  // Dilation rounds: neighbor priority down (j+1), up, right, left
  // (ascending application order left, right, up, down — last valid wins).
  std::vector<int32_t> upd(n);
  for (int r = 0; r < pad; ++r) {
    bool any = false;
    for (int j = 0; j < height; ++j) {
      for (int i = 0; i < width; ++i) {
        const int64_t idx = static_cast<int64_t>(j) * width + i;
        upd[idx] = -1;
        if (tri[idx] != -1) continue;
        if (i - 1 >= 0 && tri[idx - 1] != -1) upd[idx] = tri[idx - 1];
        if (i + 1 < width && tri[idx + 1] != -1) upd[idx] = tri[idx + 1];
        if (j - 1 >= 0 && tri[idx - width] != -1) upd[idx] = tri[idx - width];
        if (j + 1 < height && tri[idx + width] != -1) upd[idx] = tri[idx + width];
        if (upd[idx] != -1) any = true;
      }
    }
    if (!any) break;
    for (int j = 0; j < height; ++j) {
      for (int i = 0; i < width; ++i) {
        const int64_t idx = static_cast<int64_t>(j) * width + i;
        const int32_t t = upd[idx];
        if (t == -1) continue;
        double vv[6];
        for (int k = 0; k < 3; ++k) {
          vv[2 * k] = uvs[6 * t + 2 * k];
          vv[2 * k + 1] = uvs[6 * t + 2 * k + 1];
        }
        double b[2];
        barycentric(vv, double(i) / (width - 1), double(j) / (height - 1), b);
        tri[idx] = t;
        bary[2 * idx] = b[0];
        bary[2 * idx + 1] = b[1];
      }
    }
  }
}

}  // extern "C"
