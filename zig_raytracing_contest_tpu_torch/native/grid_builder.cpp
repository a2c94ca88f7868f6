// Native uniform-grid builder: exact SAT triangle-AABB binning, two-pass
// counting sort.  C++ replacement for the compute-heavy host-side "compile"
// stage the reference implements in Zig (reference: src/stage2.zig:44-135,
// SAT test src/linalg.zig:500-563).  The Python/NumPy builder
// (grid/builder.py) is the semantic oracle; this library must bin
// identically (tests/test_native_grid.py) while scaling to multi-100k
// triangle scenes with OpenMP.
//
// Semantics pinned to the reference:
//  * edges are normalized before building SAT axes (src/linalg.zig:524-526);
//    degenerate edges produce NaN axes whose comparisons never separate.
//  * candidate cells come from the clamped cell-index range of the
//    triangle's bbox (src/stage2.zig:65-66, clamp src/linalg.zig:424-427).
//  * per-cell triangle lists are in ascending triangle order (the
//    reference's pass-2 iteration order, src/stage2.zig:107-124); the
//    parallel fill uses atomic cursors then sorts each cell slice, which
//    yields the same order.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

struct V3 {
  float x, y, z;
};

inline V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline V3 norm(V3 a) {
  float l = std::sqrt(dot(a, a));
  return {a.x / l, a.y / l, a.z / l};
}

// One SAT axis test (src/linalg.zig:500-514): NaN projections return true
// (not separated), matching Zig's IEEE comparison semantics.
inline bool axis_ok(V3 a, V3 b, V3 c, V3 ext, V3 axis) {
  float p0 = dot(a, axis), p1 = dot(b, axis), p2 = dot(c, axis);
  float r = ext.x * std::fabs(axis.x) + ext.y * std::fabs(axis.y) +
            ext.z * std::fabs(axis.z);
  float maxP = std::max(p0, std::max(p1, p2));
  float minP = std::min(p0, std::min(p1, p2));
  return !(std::max(-maxP, minP) > r);
}

// Full 13-axis test (src/linalg.zig:516-563).
bool tri_aabb(const V3 *tri, V3 center, V3 ext) {
  V3 a = sub(tri[0], center), b = sub(tri[1], center), c = sub(tri[2], center);
  V3 ab = norm(sub(b, a)), bc = norm(sub(c, b)), ca = norm(sub(a, c));

  V3 axes[13] = {
      {0.0f, -ab.z, ab.y}, {0.0f, -bc.z, bc.y}, {0.0f, -ca.z, ca.y},
      {ab.z, 0.0f, -ab.x}, {bc.z, 0.0f, -bc.x}, {ca.z, 0.0f, -ca.x},
      {-ab.y, ab.x, 0.0f}, {-bc.y, bc.x, 0.0f}, {-ca.y, ca.x, 0.0f},
      {1, 0, 0},           {0, 1, 0},           {0, 0, 1},
      cross(ab, bc),
  };
  for (const V3 &axis : axes)
    if (!axis_ok(a, b, c, ext, axis)) return false;
  return true;
}

struct Grid {
  V3 bmin, cell;
  int32_t rx, ry, rz;
};

inline int32_t clampi(int32_t v, int32_t lo, int32_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// getCellIdx with clamping (src/linalg.zig:424-427; negative UB there is
// pinned to clamp-to-0 like the Python builder).
inline void cell_idx(const Grid &g, V3 p, int32_t out[3]) {
  out[0] = clampi((int32_t)((p.x - g.bmin.x) / g.cell.x), 0, g.rx - 1);
  out[1] = clampi((int32_t)((p.y - g.bmin.y) / g.cell.y), 0, g.ry - 1);
  out[2] = clampi((int32_t)((p.z - g.bmin.z) / g.cell.z), 0, g.rz - 1);
}

// getCellBbox (src/linalg.zig:433-441) + center/extents
// (src/linalg.zig:316-322), float op order preserved exactly — boundary
// cells are sensitive to it and the Python builder follows the same order.
inline void cell_center_ext(const Grid &g, int32_t x, int32_t y, int32_t z,
                            V3 *center, V3 *ext) {
  V3 lo = {g.bmin.x + (float)x * g.cell.x, g.bmin.y + (float)y * g.cell.y,
           g.bmin.z + (float)z * g.cell.z};
  V3 hi = {lo.x + g.cell.x, lo.y + g.cell.y, lo.z + g.cell.z};
  *center = {(lo.x + hi.x) * 0.5f, (lo.y + hi.y) * 0.5f, (lo.z + hi.z) * 0.5f};
  *ext = {(hi.x - lo.x) * 0.5f, (hi.y - lo.y) * 0.5f, (hi.z - lo.z) * 0.5f};
}

}  // namespace

extern "C" {

// Pass 1: per-cell reference counts.  positions: (T, 3, 3) f32 row-major.
// bbox/cell_size outputs are the scene bbox over all vertices and the
// derived cell size.  counts: (rx*ry*rz,) int32, zero-initialized by caller.
// Returns the total reference count (what pass 2's `dup` must hold).
int64_t zrc_grid_count(const float *positions, int64_t num_tris,
                       const int32_t *resolution, float *bbox_min,
                       float *bbox_max, float *cell_size, int32_t *counts) {
  const V3 *verts = reinterpret_cast<const V3 *>(positions);
  V3 lo = {INFINITY, INFINITY, INFINITY};
  V3 hi = {-INFINITY, -INFINITY, -INFINITY};
  for (int64_t i = 0; i < num_tris * 3; ++i) {
    lo.x = std::min(lo.x, verts[i].x);
    lo.y = std::min(lo.y, verts[i].y);
    lo.z = std::min(lo.z, verts[i].z);
    hi.x = std::max(hi.x, verts[i].x);
    hi.y = std::max(hi.y, verts[i].y);
    hi.z = std::max(hi.z, verts[i].z);
  }
  Grid g;
  g.bmin = lo;
  g.rx = resolution[0];
  g.ry = resolution[1];
  g.rz = resolution[2];
  g.cell = {(hi.x - lo.x) / g.rx, (hi.y - lo.y) / g.ry, (hi.z - lo.z) / g.rz};
  std::memcpy(bbox_min, &lo, 12);
  std::memcpy(bbox_max, &hi, 12);
  std::memcpy(cell_size, &g.cell, 12);

  int64_t total = 0;
#pragma omp parallel for schedule(dynamic, 64) reduction(+ : total)
  for (int64_t t = 0; t < num_tris; ++t) {
    const V3 *tri = verts + t * 3;
    V3 tlo = {std::min({tri[0].x, tri[1].x, tri[2].x}),
              std::min({tri[0].y, tri[1].y, tri[2].y}),
              std::min({tri[0].z, tri[1].z, tri[2].z})};
    V3 thi = {std::max({tri[0].x, tri[1].x, tri[2].x}),
              std::max({tri[0].y, tri[1].y, tri[2].y}),
              std::max({tri[0].z, tri[1].z, tri[2].z})};
    int32_t cmin[3], cmax[3];
    cell_idx(g, tlo, cmin);
    cell_idx(g, thi, cmax);
    for (int32_t z = cmin[2]; z <= cmax[2]; ++z)
      for (int32_t y = cmin[1]; y <= cmax[1]; ++y)
        for (int32_t x = cmin[0]; x <= cmax[0]; ++x) {
          V3 center, ext;
          cell_center_ext(g, x, y, z, &center, &ext);
          if (tri_aabb(tri, center, ext)) {
            int64_t idx = ((int64_t)z * g.ry + y) * g.rx + x;
            reinterpret_cast<std::atomic<int32_t> *>(counts)[idx].fetch_add(
                1, std::memory_order_relaxed);
            total += 1;
          }
        }
  }
  return total;
}

// Pass 2: write duplicated triangle indices.  begin: exclusive prefix sums
// of counts (caller-computed).  cursors: scratch (num_cells,) int32 zeroed.
// dup: (total,) int32 output.  Per-cell slices are sorted ascending
// afterwards to reproduce the reference's triangle-order lists.
void zrc_grid_fill(const float *positions, int64_t num_tris,
                   const int32_t *resolution, const float *bbox_min,
                   const float *cell_size, const int32_t *begin,
                   const int32_t *counts, int32_t *cursors, int32_t *dup) {
  const V3 *verts = reinterpret_cast<const V3 *>(positions);
  Grid g;
  std::memcpy(&g.bmin, bbox_min, 12);
  std::memcpy(&g.cell, cell_size, 12);
  g.rx = resolution[0];
  g.ry = resolution[1];
  g.rz = resolution[2];

#pragma omp parallel for schedule(dynamic, 64)
  for (int64_t t = 0; t < num_tris; ++t) {
    const V3 *tri = verts + t * 3;
    V3 tlo = {std::min({tri[0].x, tri[1].x, tri[2].x}),
              std::min({tri[0].y, tri[1].y, tri[2].y}),
              std::min({tri[0].z, tri[1].z, tri[2].z})};
    V3 thi = {std::max({tri[0].x, tri[1].x, tri[2].x}),
              std::max({tri[0].y, tri[1].y, tri[2].y}),
              std::max({tri[0].z, tri[1].z, tri[2].z})};
    int32_t cmin[3], cmax[3];
    cell_idx(g, tlo, cmin);
    cell_idx(g, thi, cmax);
    for (int32_t z = cmin[2]; z <= cmax[2]; ++z)
      for (int32_t y = cmin[1]; y <= cmax[1]; ++y)
        for (int32_t x = cmin[0]; x <= cmax[0]; ++x) {
          V3 center, ext;
          cell_center_ext(g, x, y, z, &center, &ext);
          if (tri_aabb(tri, center, ext)) {
            int64_t idx = ((int64_t)z * g.ry + y) * g.rx + x;
            int32_t slot =
                reinterpret_cast<std::atomic<int32_t> *>(cursors)[idx]
                    .fetch_add(1, std::memory_order_relaxed);
            dup[(int64_t)begin[idx] + slot] = (int32_t)t;
          }
        }
  }

  int64_t num_cells = (int64_t)g.rx * g.ry * g.rz;
#pragma omp parallel for schedule(dynamic, 1024)
  for (int64_t c = 0; c < num_cells; ++c)
    if (counts[c] > 1) std::sort(dup + begin[c], dup + begin[c] + counts[c]);
}

}  // extern "C"
