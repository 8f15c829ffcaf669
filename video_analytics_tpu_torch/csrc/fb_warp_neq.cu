// K-E fb_warp_neq: warp the second frame's polynomial expansion by the
// current flow and form the per-pixel normal equations of Farneback's
// displacement solve.
//
// Replaces, in video_analytics_tpu/ops/pallas/farneback_kernels.py, the
// warp and normal-equation halves of _neq_corr_axis
// (update_flow_fused_pallas), warp_neq_corr_pallas,
// corr_solve_warp_from_T_pallas, warp_emit_T_pallas and
// farneback_level_pallas, and the five-plane use of
// ops/pallas/warp.py:_axis_warp / _axis_warp_inpad (pallas_warp_cf).
//
// What it computes, per pixel p = (y, x) of pair b (one thread per pixel):
//   R1w   = bilinear sample of R1's five planes at p + flow, coordinates
//           clamped as ops/kernels.bilinear_sample clamps them;
//   inb   = floor(p + flow) within [0, size-2] on both axes
//           (flow/farneback.py _oob_mask: the last row and column are
//           always out);
//   att   = wy(y) * wx(x), the border attenuation, from the five weights
//           in the order of _border_attenuation_np;
//   M     = _normal_equations(R0, R1w, flow, inb, att) = (g11, g12, g22,
//           h1, h2), in that function's order of operations.
// Both tests on p + flow read the same float32 sum.
//
// The TPU kernels swept a band of rows and then of columns, because the
// TPU has no gather, and kept transposed copies of the planes to do so.
// Hopper gathers through L1: this is the exact 2-D sample in one pass,
// and no layout but (B, C, h, w) exists.
//
// Bound on the H100: memory.  Per pixel it reads R0 (5 planes), R1 (5
// planes, gathered: 4 taps each, neighbours' taps overlap and hit L1) and
// the flow (2), and writes M (5): 68 bytes for ~110 flops.  At 15 pairs of
// 224^2 that is 51 MB, ~15 us at 3.35 TB/s.  One pass, coalesced rows, no
// intermediate plane (the warped expansion never exists in memory).

#include "common.cuh"

namespace {

struct BorderWeights {
  float s[5];
};

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

__global__ void __launch_bounds__(va::NT)
fb_warp_neq_kernel(const float* __restrict__ R0, const float* __restrict__ R1,
                   const float* __restrict__ flow, float* __restrict__ M,
                   int h, int w, BorderWeights bw) {
  const int x = blockIdx.x * va::TX + threadIdx.x;
  const int y = blockIdx.y * va::TY + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= w || y >= h) return;
  const size_t hw = (size_t)h * w;
  const size_t o = (size_t)y * w + x;
  const float dx = flow[(size_t)b * 2 * hw + o];
  const float dy = flow[(size_t)b * 2 * hw + hw + o];

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

  const float* r0 = R0 + (size_t)b * 5 * hw + o;
  const float* r1 = R1 + (size_t)b * 5 * hw;
  float r1w[5];
#pragma unroll
  for (int c = 0; c < 5; ++c)
    r1w[c] = va::lerp2(r1 + c * hw, w, yi, xi, fy, fx);
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

  float* m = M + (size_t)b * 5 * hw + o;
  m[0] = a11 * a11 + a12 * a12;
  m[hw] = (a11 + a22) * a12;
  m[2 * hw] = a22 * a22 + a12 * a12;
  m[3 * hw] = a11 * dbx + a12 * dby;
  m[4 * hw] = a12 * dbx + a22 * dby;
}

}  // namespace

// R0, R1: (B, 5, h, w) expansions (bx, by, cxx, cyy, cxy); flow: (B, 2, h,
// w); M: (B, 5, h, w) out, planes g11, g12, g22, h1, h2.  border: the five
// attenuation weights (host).  h, w >= 2.
VA_EXPORT int va_fb_warp_neq(const float* R0, const float* R1,
                             const float* flow, float* M, int B, int h,
                             int w, const float* border, void* stream) {
  BorderWeights bw;
  for (int k = 0; k < 5; ++k) bw.s[k] = border[k];
  const dim3 block(va::TX, va::TY);
  const dim3 grid(va::cdiv(w, va::TX), va::cdiv(h, va::TY), B);
  fb_warp_neq_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(R0, R1, flow,
                                                               M, h, w, bw);
  return (int)cudaGetLastError();
}
