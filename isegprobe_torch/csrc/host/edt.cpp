// Host distance work for the simulated user and the click sampler.
//
//  1. edt_l2sq / edt_l2: the exact squared / plain Euclidean distance
//     transform of a binary mask by the Felzenszwalb-Huttenlocher two-pass
//     lower envelope of parabolas: the distance from each non-zero pixel to
//     the nearest zero pixel, 0 at zeros. Squared distances are integers,
//     exact in float32 below 2^24; the envelope's intersections are
//     compared in double, which orders any two distinct ones of rows up to
//     4096 wide exactly. A mask with no zero pixel is "infinitely far"
//     everywhere: float32(1e12) squared (1e6 plain), the value of the
//     port's scipy plain version and of its device EDT (ops/edt.py).
//
//  2. click_dist_maps: two layers (positive clicks = first half of the
//     points, negative = second half) of the minimum normalised squared
//     distance to the clicks' coordinates rounded half to even; 1e6 where a
//     layer has no valid click (a click is invalid iff max(y, x) < 0).
//
// Built with g++ -O2 -shared -fPIC at first use (utils/host_lib.py) and
// called through ctypes, which releases the GIL for the call.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// marks a column pass's "no zero in this column" inside the envelope
constexpr float kInf = 1e20f;
// the squared distance of a mask without any zero pixel
constexpr float kNoZero = 1e12f;

// 1-D squared-distance lower envelope: d[q] = min_j (f[j] + (q - j)^2).
// Only finite parabolas (f[j] < kInf) are inserted.
void dt1d(const float* f, int n, float* d, int* v, double* z) {
  constexpr double kNegInfZ = -1e30;
  constexpr double kPosInfZ = 1e30;
  int k = -1;
  for (int q = 0; q < n; ++q) {
    if (f[q] >= kInf) continue;
    if (k < 0) {
      k = 0;
      v[0] = q;
      z[0] = kNegInfZ;
      z[1] = kPosInfZ;
      continue;
    }
    double s = ((f[q] + (double)q * q) - (f[v[k]] + (double)v[k] * v[k])) /
               (2.0 * (q - v[k]));
    while (s <= z[k]) {
      --k;  // k stays >= 0: z[0] = -inf and s is finite
      s = ((f[q] + (double)q * q) - (f[v[k]] + (double)v[k] * v[k])) /
          (2.0 * (q - v[k]));
    }
    ++k;
    v[k] = q;
    z[k] = s;
    z[k + 1] = kPosInfZ;
  }

  if (k < 0) {  // no finite source anywhere in this line
    for (int q = 0; q < n; ++q) d[q] = kInf;
    return;
  }
  int kk = 0;
  for (int q = 0; q < n; ++q) {
    while (z[kk + 1] < q) ++kk;
    float dq = (float)(q - v[kk]);
    d[q] = dq * dq + f[v[kk]];
  }
}

}  // namespace

extern "C" {

// Exact squared L2 EDT. mask: h*w uint8 (row-major), out: h*w float32.
void edt_l2sq(const uint8_t* mask, int h, int w, float* out) {
  const int n = h > w ? h : w;
  std::vector<float> col(n);
  std::vector<float> res(n);
  std::vector<int> v(n);
  std::vector<double> z(n + 1);
  bool any_zero = false;

  // pass 1, columns: the squared vertical distance to a zero pixel
  for (int j = 0; j < w; ++j) {
    for (int i = 0; i < h; ++i) {
      const bool zero = !mask[(size_t)i * w + j];
      any_zero |= zero;
      col[i] = zero ? 0.0f : kInf;
    }
    dt1d(col.data(), h, res.data(), v.data(), z.data());
    for (int i = 0; i < h; ++i) out[(size_t)i * w + j] = res[i];
  }
  if (!any_zero) {
    std::fill(out, out + (size_t)h * w, kNoZero);
    return;
  }
  // pass 2, rows: the lower envelope over the column results
  for (int i = 0; i < h; ++i) {
    float* row = out + (size_t)i * w;
    for (int j = 0; j < w; ++j) col[j] = row[j];
    dt1d(col.data(), w, res.data(), v.data(), z.data());
    for (int j = 0; j < w; ++j) row[j] = res[j];
  }
}

// Exact L2 EDT: the square root of the above.
void edt_l2(const uint8_t* mask, int h, int w, float* out) {
  edt_l2sq(mask, h, w, out);
  const size_t n = (size_t)h * w;
  for (size_t i = 0; i < n; ++i) out[i] = std::sqrt(out[i]);
}

// Per-click minimum normalised squared-distance maps.
// points: n_points rows of (y, x, index) float32; the first n_points / 2
// positive. out: 2 * h * w float32.
void click_dist_maps(const float* points, int n_points, int h, int w,
                     float norm_delimiter, float* out) {
  const size_t layer = (size_t)h * w;
  std::fill(out, out + 2 * layer, 1e6f);
  const float inv = 1.0f / norm_delimiter;

  for (int p = 0; p < n_points; ++p) {
    const float py = points[p * 3 + 0];
    const float px = points[p * 3 + 1];
    if (std::max(py, px) < 0.0f) continue;
    const int li = (p >= n_points / 2) ? 1 : 0;
    const float cy = std::nearbyint(py);
    const float cx = std::nearbyint(px);
    float* dst = out + li * layer;
    for (int i = 0; i < h; ++i) {
      const float dy = (i - cy) * inv;
      const float dy2 = dy * dy;
      float* row = dst + (size_t)i * w;
      for (int j = 0; j < w; ++j) {
        const float dx = (j - cx) * inv;
        const float d2 = dy2 + dx * dx;
        if (d2 < row[j]) row[j] = d2;
      }
    }
  }
}

}  // extern "C"
