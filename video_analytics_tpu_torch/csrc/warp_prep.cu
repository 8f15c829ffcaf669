// K-A warp_prep: the TV-L1 per-warp warp of (I1, dI1/dx, dI1/dy) by the
// current flow, fused with the solver's per-warp constants.
//
// Replaces video_analytics_tpu/ops/pallas/warp.py:_axis_warp and
// _axis_warp_inpad (via pallas_warp_cf, the TV-L1 per-warp chain of
// flow/tvl1.py:_warp_step) and the warp + prep half of
// ops/pallas/tvl1_solve.py:_scale_kernel_packed (tvl1_scale_pallas).
//
// What it computes, per pixel p of each image b (one thread per pixel):
//   (I1w, I1wx, I1wy) = bilinear sample of (I1, I1x, I1y) at p + (u, v),
//     coordinates clamped as ops/kernels.bilinear_sample clamps them
//     (y0 in [0, H-2], x0 in [0, W-2]);
//   grad  = I1wx^2 + I1wy^2;
//   rho_c = I1w - I1wx*u - I1wy*v - I0              (flow/tvl1.py:121,127)
// and writes the four planes the solver reads, so the warped images never
// make a separate round trip through device memory.
//
// The TPU kernel resampled one axis at a time inside a band of +-r rows,
// because the TPU has no gather; Hopper gathers through L1, so this is
// the exact 2-D sample, which is what the reference computes on the CPU
// and with --exact.
//
// Bound on the H100: memory.  Per pixel it reads 3 gathered planes (4
// taps each, mostly L1 hits for smooth flow), u, v and I0, and writes 4
// planes: ~40 bytes of DRAM traffic for ~40 flops.  At 15 pairs of 224^2
// that is ~30 MB per call, a few microseconds at 3.35 TB/s; the design
// keeps it to one pass with coalesced rows and no intermediate planes.

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(va::NT)
warp_prep_kernel(const float* __restrict__ i13, const float* __restrict__ i0,
                 const float* __restrict__ uv, float* __restrict__ prep,
                 int H, int W) {
  const int x = blockIdx.x * va::TX + threadIdx.x;
  const int y = blockIdx.y * va::TY + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= W || y >= H) return;
  const size_t hw = (size_t)H * W;
  const size_t o = (size_t)y * W + x;
  const float* I1 = i13 + (size_t)b * 3 * hw;
  const float* I1x = I1 + hw;
  const float* I1y = I1x + hw;
  const float u0 = uv[(size_t)b * 2 * hw + o];
  const float v0 = uv[(size_t)b * 2 * hw + hw + o];

  const float ys = fminf(fmaxf((float)y + v0, 0.0f), (float)(H - 1));
  const float xs = fminf(fmaxf((float)x + u0, 0.0f), (float)(W - 1));
  const int yi = min(max((int)floorf(ys), 0), H - 2);
  const int xi = min(max((int)floorf(xs), 0), W - 2);
  const float fy = ys - (float)yi;
  const float fx = xs - (float)xi;

  const float I1w = va::lerp2(I1, W, yi, xi, fy, fx);
  const float I1wx = va::lerp2(I1x, W, yi, xi, fy, fx);
  const float I1wy = va::lerp2(I1y, W, yi, xi, fy, fx);

  float* out = prep + (size_t)b * 4 * hw;
  out[o] = I1wx;
  out[hw + o] = I1wy;
  out[2 * hw + o] = I1wx * I1wx + I1wy * I1wy;
  out[3 * hw + o] = I1w - I1wx * u0 - I1wy * v0 - i0[(size_t)b * hw + o];
}

}  // namespace

// i13: (B, 3, H, W) planes I1, I1x, I1y; i0: (B, H, W); uv: (B, 2, H, W);
// prep: (B, 4, H, W) out, planes I1wx, I1wy, grad, rho_c.  H, W >= 2.
VA_EXPORT int va_warp_prep(const float* i13, const float* i0, const float* uv,
                           float* prep, int B, int H, int W, void* stream) {
  const dim3 block(va::TX, va::TY);
  const dim3 grid(va::cdiv(W, va::TX), va::cdiv(H, va::TY), B);
  warp_prep_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(i13, i0, uv, prep,
                                                             H, W);
  return (int)cudaGetLastError();
}

// Message of a CUDA error code returned by the entry points.
VA_EXPORT const char* va_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
