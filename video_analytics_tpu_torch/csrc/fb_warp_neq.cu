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
// intermediate plane (the warped expansion never exists in memory).  The
// per-pixel arithmetic is va::neq_pixel of fb_neq.cuh.

#include "fb_neq.cuh"

namespace {

__global__ void __launch_bounds__(va::NT)
fb_warp_neq_kernel(const float* __restrict__ R0, const float* __restrict__ R1,
                   const float* __restrict__ flow, float* __restrict__ M,
                   int h, int w, va::BorderWeights bw) {
  const int x = blockIdx.x * va::TX + threadIdx.x;
  const int y = blockIdx.y * va::TY + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= w || y >= h) return;
  const size_t hw = (size_t)h * w;
  float m[5];
  va::neq_pixel(R0 + (size_t)b * 5 * hw, R1 + (size_t)b * 5 * hw,
                flow + (size_t)b * 2 * hw, h, w, y, x, bw, m);
  float* out = M + (size_t)b * 5 * hw + (size_t)y * w + x;
#pragma unroll
  for (int c = 0; c < 5; ++c) out[c * hw] = m[c];
}

}  // namespace

// R0, R1: (B, 5, h, w) expansions (bx, by, cxx, cyy, cxy); flow: (B, 2, h,
// w); M: (B, 5, h, w) out, planes g11, g12, g22, h1, h2.  border: the five
// attenuation weights (host).  h, w >= 2.
VA_EXPORT int va_fb_warp_neq(const float* R0, const float* R1,
                             const float* flow, float* M, int B, int h,
                             int w, const float* border, void* stream) {
  const dim3 block(va::TX, va::TY);
  const dim3 grid(va::cdiv(w, va::TX), va::cdiv(h, va::TY), B);
  fb_warp_neq_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      R0, R1, flow, M, h, w, va::make_border(border));
  return (int)cudaGetLastError();
}
