// Native host-side preprocessing (C ABI, loaded with ctypes by
// lidar4d_tpu_torch/native/__init__.py, which builds it with
// g++ -O3 -shared -fPIC -std=c++17).
//
// Two entries the reference ran as native or Python host code: the
// per-point range-view projection loop (utils/convert.py:4-65, a Python loop
// upstream) and open3d's C++ remove_statistical_outlier (utils/misc.py:133,
// 151). The arithmetic is kept line for line with the JAX package's copy, so
// one compiler gives both the same bits.

#include <cmath>
#include <cstdint>
#include <algorithm>
#include <vector>

extern "C" {

// Project (N,4) lidar points (xyz + intensity) to an H x W range pano with a
// min-depth z-buffer. Ties break to the earliest point (strict '>' compare),
// matching utils/convert.py:55-63. pano/intens must be zero-initialized.
void lidar_to_pano(const float* pts, int64_t n, int64_t H, int64_t W,
                   double fov_up, double fov, double max_depth,
                   double* pano, double* intens) {
  const double pi = 3.14159265358979323846;
  const double fov_down = fov - fov_up;
  for (int64_t i = 0; i < n; ++i) {
    const double x = pts[i * 4 + 0];
    const double y = pts[i * 4 + 1];
    const double z = pts[i * 4 + 2];
    const double inten = pts[i * 4 + 3];
    const double dist = std::sqrt(x * x + y * y + z * z);
    if (dist >= max_depth) continue;
    const double beta = pi - std::atan2(y, x);
    const double alpha =
        std::atan2(z, std::sqrt(x * x + y * y)) + fov_down / 180.0 * pi;
    const int64_t c = std::llround(beta / (2.0 * pi / (double)W));
    const int64_t r =
        std::llround((double)H - alpha / (fov / 180.0 * pi / (double)H));
    if (r < 0 || r >= H || c < 0 || c >= W) continue;
    double* cell = pano + r * W + c;
    if (*cell == 0.0 || *cell > dist) {
      *cell = dist;
      intens[r * W + c] = inten;
    }
  }
}

// Statistical outlier removal (open3d semantics): for each point, the mean
// distance to its k nearest neighbors; keep points with
// mean < mean_all + std_ratio * std_all. Exact kNN via a uniform voxel grid
// with ring-expansion search. Writes a 0/1 mask.
void knn_outlier_mask(const float* pts, int64_t n, int64_t k,
                      double std_ratio, uint8_t* mask) {
  if (n <= k) {
    std::fill(mask, mask + n, 1);
    return;
  }
  // bounding box + voxel size targeting ~2k points per cell
  float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
  for (int64_t i = 0; i < n; ++i)
    for (int d = 0; d < 3; ++d) {
      lo[d] = std::min(lo[d], pts[i * 3 + d]);
      hi[d] = std::max(hi[d], pts[i * 3 + d]);
    }
  const double vol = std::max(1e-9, (double)(hi[0] - lo[0]) *
                                        (hi[1] - lo[1]) * (hi[2] - lo[2]));
  double cell = std::cbrt(vol * (double)(k + 1) / (double)n);
  cell = std::max(cell, 1e-6);
  int64_t nx = std::max<int64_t>(1, (int64_t)((hi[0] - lo[0]) / cell) + 1);
  int64_t ny = std::max<int64_t>(1, (int64_t)((hi[1] - lo[1]) / cell) + 1);
  int64_t nz = std::max<int64_t>(1, (int64_t)((hi[2] - lo[2]) / cell) + 1);

  auto cell_of = [&](int64_t i, int64_t& cx, int64_t& cy, int64_t& cz) {
    cx = std::min<int64_t>(nx - 1, (int64_t)((pts[i * 3 + 0] - lo[0]) / cell));
    cy = std::min<int64_t>(ny - 1, (int64_t)((pts[i * 3 + 1] - lo[1]) / cell));
    cz = std::min<int64_t>(nz - 1, (int64_t)((pts[i * 3 + 2] - lo[2]) / cell));
  };

  // bucket points by cell (counting sort)
  std::vector<int64_t> counts(nx * ny * nz + 1, 0);
  std::vector<int64_t> cidx(n);
  for (int64_t i = 0; i < n; ++i) {
    int64_t cx, cy, cz;
    cell_of(i, cx, cy, cz);
    cidx[i] = (cx * ny + cy) * nz + cz;
    counts[cidx[i] + 1]++;
  }
  for (size_t c = 1; c < counts.size(); ++c) counts[c] += counts[c - 1];
  std::vector<int64_t> order(n);
  {
    std::vector<int64_t> cursor(counts.begin(), counts.end() - 1);
    for (int64_t i = 0; i < n; ++i) order[cursor[cidx[i]]++] = i;
  }

  std::vector<double> mean_d(n);
  std::vector<double> best;  // max-heap of squared distances, size <= k
  for (int64_t i = 0; i < n; ++i) {
    int64_t cx, cy, cz;
    cell_of(i, cx, cy, cz);
    best.clear();
    const double px = pts[i * 3], py = pts[i * 3 + 1], pz = pts[i * 3 + 2];
    // ring expansion: stop when the k-th best is closer than the nearest
    // possible point in the next unexplored ring
    for (int64_t ring = 0;; ++ring) {
      if ((int64_t)best.size() == k) {
        const double ring_min = (double)(ring - 1) * cell;  // conservative
        if (ring > 0 && best.front() <= ring_min * ring_min) break;
      }
      bool any_cell = false;
      for (int64_t dx = -ring; dx <= ring; ++dx)
        for (int64_t dy = -ring; dy <= ring; ++dy)
          for (int64_t dz = -ring; dz <= ring; ++dz) {
            if (std::max({std::llabs(dx), std::llabs(dy), std::llabs(dz)}) !=
                ring)
              continue;  // shell only
            const int64_t gx = cx + dx, gy = cy + dy, gz = cz + dz;
            if (gx < 0 || gx >= nx || gy < 0 || gy >= ny || gz < 0 || gz >= nz)
              continue;
            any_cell = true;
            const int64_t c = (gx * ny + gy) * nz + gz;
            for (int64_t s = counts[c]; s < counts[c + 1]; ++s) {
              const int64_t j = order[s];
              if (j == i) continue;
              const double ddx = px - pts[j * 3], ddy = py - pts[j * 3 + 1],
                           ddz = pz - pts[j * 3 + 2];
              const double d2 = ddx * ddx + ddy * ddy + ddz * ddz;
              if ((int64_t)best.size() < k) {
                best.push_back(d2);
                std::push_heap(best.begin(), best.end());
              } else if (d2 < best.front()) {
                std::pop_heap(best.begin(), best.end());
                best.back() = d2;
                std::push_heap(best.begin(), best.end());
              }
            }
          }
      if (!any_cell && ring > std::max({nx, ny, nz})) break;
    }
    double s = 0.0;
    for (double d2 : best) s += std::sqrt(d2);
    mean_d[i] = best.empty() ? 0.0 : s / (double)best.size();
  }

  double mu = 0.0;
  for (int64_t i = 0; i < n; ++i) mu += mean_d[i];
  mu /= (double)n;
  double var = 0.0;
  for (int64_t i = 0; i < n; ++i) var += (mean_d[i] - mu) * (mean_d[i] - mu);
  const double thresh = mu + std_ratio * std::sqrt(var / (double)n);
  for (int64_t i = 0; i < n; ++i) mask[i] = mean_d[i] < thresh ? 1 : 0;
}

}  // extern "C"
