// Farneback's per-pixel normal equations, shared by fb_warp_neq.cu (one
// thread per pixel, M written to device memory) and fb_window_solve.cu
// (the same arithmetic as the tile loader of the window average).
#pragma once

#include "common.cuh"

namespace va {

struct BorderWeights {
  float s[5];
};

inline BorderWeights make_border(const float* border) {
  BorderWeights bw;
  for (int k = 0; k < 5; ++k) bw.s[k] = border[k];
  return bw;
}

// Attenuation of coordinate i on an axis of length n: the weights applied
// in order, the low side before the high side.
__device__ __forceinline__ float attenuation(int i, int n,
                                             const BorderWeights& bw) {
  float a = 1.0f;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    if (k < n) {
      if (i == k) a *= bw.s[k];
      if (i == n - 1 - k) a *= bw.s[k];
    }
  }
  return a;
}

// (g11, g12, g22, h1, h2) at pixel (y, x) of one pair: R0, R1 point at the
// pair's five (h, w) planes, flow at its two.  The bilinear sample of R1
// at p + flow with coordinates clamped as ops/kernels.bilinear_sample
// clamps them, the interior test of flow/farneback.py _oob_mask (both read
// the same float32 sum), the border attenuation and _normal_equations, in
// that function's order of operations.
__device__ __forceinline__ void neq_pixel(const float* __restrict__ R0,
                                          const float* __restrict__ R1,
                                          const float* __restrict__ flow,
                                          int h, int w, int y, int x,
                                          const BorderWeights& bw,
                                          float m[5]) {
  const size_t hw = (size_t)h * w;
  const size_t o = (size_t)y * w + x;
  const float dx = flow[o];
  const float dy = flow[hw + o];

  const float px = (float)x + dx;
  const float py = (float)y + dy;
  const float x1 = floorf(px);
  const float y1 = floorf(py);
  const bool inb = x1 >= 0.0f && x1 < (float)(w - 1) && y1 >= 0.0f &&
                   y1 < (float)(h - 1);

  const float ys = fminf(fmaxf(py, 0.0f), (float)(h - 1));
  const float xs = fminf(fmaxf(px, 0.0f), (float)(w - 1));
  const int yi = min(max((int)floorf(ys), 0), h - 2);
  const int xi = min(max((int)floorf(xs), 0), w - 2);
  const float fy = ys - (float)yi;
  const float fx = xs - (float)xi;

  const float* r0 = R0 + o;
  float r1w[5];
#pragma unroll
  for (int c = 0; c < 5; ++c)
    r1w[c] = lerp2(R1 + c * hw, w, yi, xi, fy, fx);
  const float r00 = r0[0], r01 = r0[hw], r02 = r0[2 * hw], r03 = r0[3 * hw],
              r04 = r0[4 * hw];

  float a11 = inb ? (r02 + r1w[2]) * 0.5f : r02;
  float a22 = inb ? (r03 + r1w[3]) * 0.5f : r03;
  float a12 = inb ? (r04 + r1w[4]) * 0.25f : r04 * 0.5f;
  const float b1w = inb ? r1w[0] : 0.0f;
  const float b2w = inb ? r1w[1] : 0.0f;
  float dbx = (r00 - b1w) * 0.5f + a11 * dx + a12 * dy;
  float dby = (r01 - b2w) * 0.5f + a12 * dx + a22 * dy;

  const float att = attenuation(y, h, bw) * attenuation(x, w, bw);
  a11 = a11 * att;
  a22 = a22 * att;
  a12 = a12 * att;
  dbx = dbx * att;
  dby = dby * att;

  m[0] = a11 * a11 + a12 * a12;
  m[1] = (a11 + a22) * a12;
  m[2] = a22 * a22 + a12 * a12;
  m[3] = a11 * dbx + a12 * dby;
  m[4] = a12 * dbx + a22 * dby;
}

// Farneback's regularised 2x2 solve (flow/farneback.py _solve_flow) from
// the five averaged sums of one pixel.
__device__ __forceinline__ void solve_flow(const float acc[5], float* fx,
                                           float* fy) {
  const float g11 = acc[0], g12 = acc[1], g22 = acc[2], h1 = acc[3],
              h2 = acc[4];
  const float idet = 1.0f / (g11 * g22 - g12 * g12 + 1e-3f);
  *fx = (g22 * h1 - g12 * h2) * idet;
  *fy = (g11 * h2 - g12 * h1) * idet;
}

}  // namespace va
