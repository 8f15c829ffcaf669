// K-F sep_corr: 1-D correlation of (B, C, h, w) planes along one axis with
// a replicate border, and, as an epilogue for C = 5, Farneback's
// regularised 2x2 solve.
//
// Replaces video_analytics_tpu/ops/pallas/farneback_kernels.py:
// _sep_corr_axis (sep_corr2d_pallas, update_flow_pallas) and the
// window-average and solve halves of _neq_corr_axis, warp_neq_corr_pallas,
// corr_solve_from_T_pallas, corr_solve_warp_from_T_pallas and
// farneback_level_pallas.
//
// What it computes, per plane and pixel:
//   y(p) = k[0]*x(p - r) + k[1]*x(p - r + 1) + ... along the axis, summed
//          in that order (ops/kernels._conv1d), indices clamped to the
//          plane (replicate border);
// and with the epilogue, from the five sums (g11, g12, g22, h1, h2) of one
// pixel:
//   idet = 1 / (g11*g22 - g12*g12 + 1e-3)
//   flow = ((g22*h1 - g12*h2) * idet, (g11*h2 - g12*h1) * idet)
// (flow/farneback.py _solve_flow), written as (B, 2, h, w).
//
// One Farneback iteration is K-E, then this along y, then this along x
// with the epilogue; fb_window_solve.cu computes the same in one launch and
// is what the pyramid loop calls.  The taps are kept as the host makes them: the box
// window is fifteen taps of float32(1/15), not a running sum, so the
// result equals the plain version's to the bit.
//
// The TPU kernels correlated along rows only (the sublane axis), kept a
// transposed copy for the other axis, and cached doubling window sums;
// here the axis is an argument and both run on the (B, C, h, w) layout.
//
// Design.  A block makes a 32x8 tile of outputs of P planes (P = 1, or 5
// with the epilogue, where one thread needs the five sums of its pixel).
// The tile and its halo of r pixels along the axis go to shared memory
// once, with the taps (any odd number, copied from device memory); each
// thread then sums its taps from there.  The buffer is dynamic: (8 + 2r) x
// 32 floats a plane along y, 8 x (32 + 2r) along x, so a block's 227 KB
// take r up to 876 along y and, with the five planes of the solve, 693
// along x.  Farneback's window takes this kernel where its window is too
// long for fb_window_solve.cu's tile (r > 96).
//
// Bound on the H100: memory.  Each input pixel is read once and each
// output written once: 8 bytes per pixel and plane for 2*taps flops (30
// for the default window), 4.8 bytes with the epilogue.  At 15 pairs of
// 224^2 and 5 planes that is 30 MB, ~9 us at 3.35 TB/s.  The vertical pass
// reads (8 + 2r)/8 rows per output row from L2; taller tiles are the next
// step.

#include "fb_neq.cuh"

namespace {

constexpr int MAX_SMEM = 232448;      // bytes a block may opt in to

// Floats of one plane's tile with its halo along the axis.
__host__ __device__ inline long long tile_floats(int r, int axis) {
  return axis == 0 ? (long long)(va::TY + 2 * r) * va::TX
                   : (long long)va::TY * (va::TX + 2 * r);
}

template <int P, bool SOLVE>
__global__ void __launch_bounds__(va::NT)
sep_corr_kernel(const float* __restrict__ x, float* __restrict__ out, int h,
                int w, const float* __restrict__ taps, int n, int axis) {
  extern __shared__ float sm[];
  const int r = n / 2;
  const int plane = (int)tile_floats(r, axis);
  float* tk = sm + P * plane;
  const int tid = threadIdx.y * va::TX + threadIdx.x;
  const int x0 = blockIdx.x * va::TX;
  const int y0 = blockIdx.y * va::TY;
  const size_t hw = (size_t)h * w;
  const float* in = x + (size_t)blockIdx.z * P * hw;
  // Tile shape: the halo is along the correlation axis only.
  const int tw = axis == 1 ? va::TX + 2 * r : va::TX;
  const int th = axis == 0 ? va::TY + 2 * r : va::TY;
  const int ox = axis == 1 ? r : 0;
  const int oy = axis == 0 ? r : 0;

  for (int i = tid; i < n; i += va::NT) tk[i] = taps[i];
  for (int i = tid; i < th * tw; i += va::NT) {
    const int gy = min(max(y0 + i / tw - oy, 0), h - 1);
    const int gx = min(max(x0 + i % tw - ox, 0), w - 1);
#pragma unroll
    for (int p = 0; p < P; ++p)
      sm[p * plane + i] = in[p * hw + (size_t)gy * w + gx];
  }
  __syncthreads();

  const int px = x0 + threadIdx.x;
  const int py = y0 + threadIdx.y;
  if (px >= w || py >= h) return;
  const int base = threadIdx.y * tw + threadIdx.x;
  const int step = axis == 1 ? 1 : tw;
  float acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    float a = 0.0f;
    for (int k = 0; k < n; ++k) {
      const float term = tk[k] * sm[p * plane + base + k * step];
      a = k == 0 ? term : a + term;
    }
    acc[p] = a;
  }

  const size_t o = (size_t)py * w + px;
  if constexpr (SOLVE) {
    float* f = out + (size_t)blockIdx.z * 2 * hw + o;
    va::solve_flow(acc, f, f + hw);
  } else {
#pragma unroll
    for (int p = 0; p < P; ++p)
      out[((size_t)blockIdx.z * P + p) * hw + o] = acc[p];
  }
}

template <int P, bool SOLVE>
int launch(const float* x, float* out, int h, int w, const float* taps, int n,
           int axis, dim3 grid, cudaStream_t s) {
  static int smem_set = 0;            // what this instantiation has opted in to
  const long long bytes = (P * tile_floats(n / 2, axis) + n) * sizeof(float);
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int smem = (int)bytes;
  if (smem > smem_set) {              // above 48 KB a kernel must opt in
    cudaError_t err = cudaFuncSetAttribute(
        sep_corr_kernel<P, SOLVE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
    smem_set = smem;
  }
  sep_corr_kernel<P, SOLVE><<<grid, dim3(va::TX, va::TY), smem, s>>>(
      x, out, h, w, taps, n, axis);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, C, h, w); out: (B, C, h, w), or (B, 2, h, w) with solve (C = 5).
// taps: n taps in device memory, n odd.  axis 0 correlates along y, axis 1
// along x.
VA_EXPORT int va_sep_corr(const float* x, float* out, int B, int C, int h,
                          int w, const float* taps, int n, int axis,
                          int solve, void* stream) {
  if (n < 1 || n % 2 != 1 || (axis != 0 && axis != 1) || (solve && C != 5) ||
      taps == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (solve)
    return launch<5, true>(x, out, h, w, taps, n, axis,
                           dim3(va::cdiv(w, va::TX), va::cdiv(h, va::TY), B),
                           s);
  return launch<1, false>(
      x, out, h, w, taps, n, axis,
      dim3(va::cdiv(w, va::TX), va::cdiv(h, va::TY), B * C), s);
}
