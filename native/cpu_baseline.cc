// CPU-baseline twin of the flagship per-frame pipeline, in plain -O3 C++.
//
// Measures what the reference's C++/PCL stack (deproject -> transform ->
// concat -> VoxelGrid, plus the north star's >=5 ICP iters/pair/frame)
// sustains on the host CPU, so the ">=10x CPU baseline" ratio can be a
// measured number instead of a claim (BASELINE.md line 16; reference
// publishes no numbers — BASELINE.json "published": {}).
//
// Same math as tests/oracle.py (the PCL-parity contract):
//   * deproject: rs2_deproject_pixel_to_point (no distortion), z gates
//   * voxel grid: floor(p * (1/leaf)) indices, centroid per occupied voxel
//     (hash map stands in for PCL's sorted-leaf pass — it is faster, which
//     is the generous direction for a baseline)
//   * ICP: NN correspondences via a uniform grid hash at cell = max_corr
//     (the role pcl::KdTreeFLANN plays), max-distance rejection, closed-form
//     rigid solve (Horn's quaternion method = TransformationEstimationSVD's
//     result), 5 iterations per camera pair
//
// Build: make cpu-baseline     Run: native/cpu-baseline [ncam] [frames]
// Output: one JSON line {"frame_ms": ..., "cpu_pps": ...}.
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <chrono>
#include <unordered_map>
#include <vector>

namespace {

struct V3 { float x, y, z; };

struct Mat4 {
  float m[16];
  static Mat4 eye() {
    Mat4 t{};
    t.m[0] = t.m[5] = t.m[10] = t.m[15] = 1.f;
    return t;
  }
};

Mat4 matmul(const Mat4& a, const Mat4& b) {
  Mat4 r{};
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 4; j++) {
      float s = 0.f;
      for (int k = 0; k < 4; k++) s += a.m[i * 4 + k] * b.m[k * 4 + j];
      r.m[i * 4 + j] = s;
    }
  return r;
}

inline V3 apply(const Mat4& t, const V3& p) {
  return {t.m[0] * p.x + t.m[1] * p.y + t.m[2] * p.z + t.m[3],
          t.m[4] * p.x + t.m[5] * p.y + t.m[6] * p.z + t.m[7],
          t.m[8] * p.x + t.m[9] * p.y + t.m[10] * p.z + t.m[11]};
}

// ---- synthetic depth (structurally like tests/oracle.synth_depth_frame) ----
void synth_depth(uint16_t* d, int h, int w, int seed) {
  const float pi = 3.14159265f;
  for (int v = 0; v < h; v++)
    for (int u = 0; u < w; u++) {
      float z = 1500.f + 500.f * std::sin(u / (w * 0.23f)) +
                400.f * std::cos(v / (h * 0.19f)) +
                150.f * std::sin(u / (w * 0.041f) + 1.f + seed) +
                120.f * std::cos(v / (h * 0.037f));
      // ~7% holes, deterministic hash
      uint32_t hsh = (u * 73856093u) ^ (v * 19349663u) ^ (seed * 83492791u);
      if ((hsh % 100) < 7) z = 0.f;
      if (z < 0.f) z = 0.f;
      if (z > 4000.f) z = 4000.f;
      d[v * w + u] = (uint16_t)z;
      (void)pi;
    }
}

// ---- deproject (librealsense math, z-gated) ----
size_t deproject(const uint16_t* depth, int h, int w, float fx, float fy,
                 float ppx, float ppy, std::vector<V3>* out) {
  out->clear();
  out->reserve((size_t)h * w);
  for (int v = 0; v < h; v++)
    for (int u = 0; u < w; u++) {
      float z = depth[v * w + u] * 0.001f;
      if (z <= 0.1f || z > 10.f) continue;
      out->push_back({(u - ppx) / fx * z, (v - ppy) / fy * z, z});
    }
  return out->size();
}

// ---- voxel grid (PCL centroid semantics; hash-map uniquing) ----
struct Accum { double x = 0, y = 0, z = 0; int n = 0; };

size_t voxel_grid(const std::vector<V3>& pts, float leaf,
                  std::vector<V3>* out) {
  const float inv = 1.f / leaf;
  std::unordered_map<uint64_t, Accum> cells;
  cells.reserve(pts.size() / 4);
  for (const V3& p : pts) {
    int64_t ix = (int64_t)std::floor(p.x * inv) + (1 << 20);
    int64_t iy = (int64_t)std::floor(p.y * inv) + (1 << 20);
    int64_t iz = (int64_t)std::floor(p.z * inv) + (1 << 20);
    uint64_t key = ((uint64_t)ix << 42) | ((uint64_t)iy << 21) | (uint64_t)iz;
    Accum& a = cells[key];
    a.x += p.x; a.y += p.y; a.z += p.z; a.n++;
  }
  out->clear();
  out->reserve(cells.size());
  for (auto& kv : cells) {
    const Accum& a = kv.second;
    out->push_back({(float)(a.x / a.n), (float)(a.y / a.n),
                    (float)(a.z / a.n)});
  }
  return out->size();
}

// ---- NN via uniform grid hash at cell = max_corr (KdTreeFLANN's role) ----
struct GridNN {
  float cell, inv;
  std::unordered_map<uint64_t, std::vector<int>> bins;
  const std::vector<V3>* pts;

  static uint64_t key3(int64_t ix, int64_t iy, int64_t iz) {
    return ((uint64_t)(ix + (1 << 20)) << 42) |
           ((uint64_t)(iy + (1 << 20)) << 21) | (uint64_t)(iz + (1 << 20));
  }

  void build(const std::vector<V3>& p, float c) {
    cell = c; inv = 1.f / c; pts = &p;
    bins.clear();
    bins.reserve(p.size());
    for (int i = 0; i < (int)p.size(); i++) {
      int64_t ix = (int64_t)std::floor(p[i].x * inv);
      int64_t iy = (int64_t)std::floor(p[i].y * inv);
      int64_t iz = (int64_t)std::floor(p[i].z * inv);
      bins[key3(ix, iy, iz)].push_back(i);
    }
  }

  // nearest neighbour within max_corr; returns -1 if none in the 27 cells
  int query(const V3& q, float* d2out) const {
    int64_t ix = (int64_t)std::floor(q.x * inv);
    int64_t iy = (int64_t)std::floor(q.y * inv);
    int64_t iz = (int64_t)std::floor(q.z * inv);
    int best = -1;
    float bd2 = cell * cell;
    for (int dx = -1; dx <= 1; dx++)
      for (int dy = -1; dy <= 1; dy++)
        for (int dz = -1; dz <= 1; dz++) {
          auto it = bins.find(key3(ix + dx, iy + dy, iz + dz));
          if (it == bins.end()) continue;
          for (int i : it->second) {
            const V3& r = (*pts)[i];
            float ddx = q.x - r.x, ddy = q.y - r.y, ddz = q.z - r.z;
            float d2 = ddx * ddx + ddy * ddy + ddz * ddz;
            if (d2 < bd2) { bd2 = d2; best = i; }
          }
        }
    *d2out = bd2;
    return best;
  }
};

// ---- rigid solve: Horn's quaternion method (== SVD estimation result) ----
Mat4 rigid_solve(const std::vector<V3>& src, const std::vector<V3>& dst,
                 const std::vector<int>& corr) {
  double csx = 0, csy = 0, csz = 0, cdx = 0, cdy = 0, cdz = 0;
  int n = 0;
  for (size_t i = 0; i < src.size(); i++) {
    if (corr[i] < 0) continue;
    const V3& s = src[i]; const V3& d = dst[corr[i]];
    csx += s.x; csy += s.y; csz += s.z;
    cdx += d.x; cdy += d.y; cdz += d.z;
    n++;
  }
  if (n < 3) return Mat4::eye();
  csx /= n; csy /= n; csz /= n; cdx /= n; cdy /= n; cdz /= n;

  double H[9] = {0};  // cross-covariance src->dst
  for (size_t i = 0; i < src.size(); i++) {
    if (corr[i] < 0) continue;
    const V3& s = src[i]; const V3& d = dst[corr[i]];
    double sx = s.x - csx, sy = s.y - csy, sz = s.z - csz;
    double dx = d.x - cdx, dy = d.y - cdy, dz = d.z - cdz;
    H[0] += sx * dx; H[1] += sx * dy; H[2] += sx * dz;
    H[3] += sy * dx; H[4] += sy * dy; H[5] += sy * dz;
    H[6] += sz * dx; H[7] += sz * dy; H[8] += sz * dz;
  }
  // Horn's 4x4 N matrix; max eigenvector = optimal quaternion
  double N[16] = {
      H[0] + H[4] + H[8], H[5] - H[7],        H[6] - H[2],        H[1] - H[3],
      H[5] - H[7],        H[0] - H[4] - H[8], H[1] + H[3],        H[2] + H[6],
      H[6] - H[2],        H[1] + H[3],        H[4] - H[0] - H[8], H[5] + H[7],
      H[1] - H[3],        H[2] + H[6],        H[5] + H[7],        H[8] - H[0] - H[4]};
  double q[4] = {1, 0, 0, 0};
  for (int it = 0; it < 50; it++) {  // shifted power iteration
    double r[4];
    double shift = std::abs(N[0]) + std::abs(N[5]) + std::abs(N[10]) +
                   std::abs(N[15]) + 1.0;
    for (int i = 0; i < 4; i++) {
      r[i] = shift * q[i];
      for (int j = 0; j < 4; j++) r[i] += N[i * 4 + j] * q[j];
    }
    double nm = std::sqrt(r[0] * r[0] + r[1] * r[1] + r[2] * r[2] + r[3] * r[3]);
    for (int i = 0; i < 4; i++) q[i] = r[i] / nm;
  }
  double w = q[0], x = q[1], y = q[2], z = q[3];
  Mat4 T = Mat4::eye();
  T.m[0] = (float)(1 - 2 * (y * y + z * z));
  T.m[1] = (float)(2 * (x * y - w * z));
  T.m[2] = (float)(2 * (x * z + w * y));
  T.m[4] = (float)(2 * (x * y + w * z));
  T.m[5] = (float)(1 - 2 * (x * x + z * z));
  T.m[6] = (float)(2 * (y * z - w * x));
  T.m[8] = (float)(2 * (x * z - w * y));
  T.m[9] = (float)(2 * (y * z + w * x));
  T.m[10] = (float)(1 - 2 * (x * x + y * y));
  T.m[3] = (float)(cdx - (T.m[0] * csx + T.m[1] * csy + T.m[2] * csz));
  T.m[7] = (float)(cdy - (T.m[4] * csx + T.m[5] * csy + T.m[6] * csz));
  T.m[11] = (float)(cdz - (T.m[8] * csx + T.m[9] * csy + T.m[10] * csz));
  return T;
}

Mat4 icp(const std::vector<V3>& src, const std::vector<V3>& dst,
         int iterations, float max_corr) {
  GridNN nn;
  nn.build(dst, max_corr);
  Mat4 T = Mat4::eye();
  std::vector<V3> p(src.size());
  std::vector<int> corr(src.size());
  for (int it = 0; it < iterations; it++) {
    for (size_t i = 0; i < src.size(); i++) p[i] = apply(T, src[i]);
    for (size_t i = 0; i < p.size(); i++) {
      float d2;
      corr[i] = nn.query(p[i], &d2);
    }
    T = matmul(rigid_solve(p, dst, corr), T);
  }
  return T;
}

}  // namespace

int main(int argc, char** argv) {
  const int ncam = argc > 1 ? std::atoi(argv[1]) : 8;
  const int frames = argc > 2 ? std::atoi(argv[2]) : 3;
  const int h = 480, w = 848;
  const int icp_stride = 6, icp_iters = 5;
  const float icp_leaf = 0.05f, icp_max_corr = 0.1f, out_leaf = 0.01f;
  const float fx = 421.5f, fy = 421.1f, ppx = w / 2.f, ppy = h / 2.f;

  std::vector<std::vector<uint16_t>> depths(ncam,
                                            std::vector<uint16_t>(h * w));
  std::vector<Mat4> exts(ncam, Mat4::eye());
  for (int c = 0; c < ncam; c++) {
    synth_depth(depths[c].data(), h, w, c);
    exts[c].m[3] = 0.05f * c;  // small per-camera offsets, like _flagship
    exts[c].m[7] = -0.03f * c;
  }

  size_t voxels = 0;
  double best_s = 1e30;
  std::vector<V3> cloud, sub, icp_cloud, fused, out;
  std::vector<std::vector<V3>> icp_clouds(ncam);
  for (int f = 0; f < frames + 1; f++) {  // first iteration warms allocators
    auto t0 = std::chrono::steady_clock::now();
    fused.clear();
    std::vector<Mat4> ext = exts;

    for (int c = 0; c < ncam; c++) {
      deproject(depths[c].data(), h, w, fx, fy, ppx, ppy, &cloud);
      // ICP subsample: grid stride on the organised frame, then small voxel
      sub.clear();
      for (int v = 0; v < h; v += icp_stride)
        for (int u = 0; u < w; u += icp_stride) {
          float z = depths[c][v * w + u] * 0.001f;
          if (z <= 0.1f || z > 10.f) continue;
          sub.push_back({(u - ppx) / fx * z, (v - ppy) / fy * z, z});
        }
      voxel_grid(sub, icp_leaf, &icp_clouds[c]);
      for (V3& p : icp_clouds[c]) p = apply(ext[c], p);

      // ring drift correction against the previous camera
      if (c > 0) {
        Mat4 dT = icp(icp_clouds[c], icp_clouds[c - 1], icp_iters,
                      icp_max_corr);
        ext[c] = matmul(dT, ext[c]);
        for (V3& p : icp_clouds[c]) p = apply(dT, p);
      }

      // full cloud into world frame, concat (reference dataflow)
      for (const V3& p : cloud) fused.push_back(apply(ext[c], p));
    }
    voxels = voxel_grid(fused, out_leaf, &out);
    double dt = std::chrono::duration<double>(
                    std::chrono::steady_clock::now() - t0).count();
    if (f > 0 && dt < best_s) best_s = dt;
  }

  double pps = (double)ncam * h * w / best_s;
  std::printf(
      "{\"impl\": \"C++ -O3 (hash voxel, grid-hash NN, Horn solve)\", "
      "\"cameras\": %d, \"frame_ms\": %.1f, \"cpu_pps\": %.0f, "
      "\"fused_voxels\": %zu}\n",
      ncam, best_s * 1e3, pps, voxels);
  return 0;
}
