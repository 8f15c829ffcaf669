// K-C median5: k x k median (k = 3 or 5) of flow planes, replicate border,
// with an optional per-image mask.
//
// Replaces the in-kernel median of video_analytics_tpu/ops/pallas/
// tvl1_solve.py (_median2d in _solver_kernel, _median2d_xi in
// _pd_solve_packed and _scale_kernel_packed) and the scale-end median of
// flow/tvl1.py (ops/median.median_filter2d, XLA in the reference).
//
// Each 32x8 block stages its tile with a halo of k/2 pixels in shared
// memory, loading clamped coordinates (the replicate border).  Each
// thread then gathers its k^2 window into registers, in the reference's
// row-major order, and runs the pruned Batcher selection network of
// ops/median._median_network: 113 compare-exchanges (min/max) for 25
// values.  The network is generated from that function at build time
// (median_network.h, see ops/cuda/_build.py), so there is one source of
// truth.  The median of k^2 values does not depend on the network, so
// the result equals the plain version bit for bit.
//
// With a mask (`active`, one int per image; image = plane / planes_per_
// image), blocks of a masked-off image copy their tile through unchanged:
// the TV-L1 solver filters only the images that have not converged.
//
// Bound on the H100: compute in the selection network (~230 min/max per
// output at k = 5) against 8 bytes of DRAM traffic per output; the tile
// and halo come through shared memory once, so device memory is read
// ~1.4x per plane (halo overhead) and written once.

#include "common.cuh"
#include "median_network.h"

namespace {

template <int K>
__device__ __forceinline__ float select_median(float* w);

template <>
__device__ __forceinline__ float select_median<3>(float* w) {
  return va_median9(w);
}

template <>
__device__ __forceinline__ float select_median<5>(float* w) {
  return va_median25(w);
}

template <int K>
__global__ void __launch_bounds__(va::NT)
median_kernel(const float* __restrict__ in, float* __restrict__ out, int H,
              int W, int planes_per_image, const int* __restrict__ active) {
  using va::TX;
  using va::TY;
  constexpr int R = K / 2;
  __shared__ float tile[TY + 2 * R][TX + 2 * R];
  const int plane = blockIdx.z;
  const size_t hw = (size_t)H * W;
  const float* src = in + (size_t)plane * hw;
  float* dst = out + (size_t)plane * hw;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int x = x0 + tx, y = y0 + ty;
  const bool inside = x < W && y < H;

  if (active != nullptr && !active[plane / planes_per_image]) {
    if (inside) dst[(size_t)y * W + x] = src[(size_t)y * W + x];
    return;
  }
  for (int i = tid; i < (TY + 2 * R) * (TX + 2 * R); i += va::NT) {
    const int r = i / (TX + 2 * R), c = i % (TX + 2 * R);
    const int gy = min(max(y0 - R + r, 0), H - 1);
    const int gx = min(max(x0 - R + c, 0), W - 1);
    tile[r][c] = src[(size_t)gy * W + gx];
  }
  __syncthreads();
  if (!inside) return;
  float w[K * K];
#pragma unroll
  for (int dy = 0; dy < K; ++dy)
#pragma unroll
    for (int dx = 0; dx < K; ++dx) w[dy * K + dx] = tile[ty + dy][tx + dx];
  dst[(size_t)y * W + x] = select_median<K>(w);
}

}  // namespace

// in/out: n_planes planes of (H, W), distinct buffers; k in {3, 5};
// active: null, or one int per image of planes_per_image planes.
VA_EXPORT int va_median(const float* in, float* out, int n_planes,
                        int planes_per_image, int H, int W, int k,
                        const int* active, void* stream) {
  const dim3 block(va::TX, va::TY);
  const dim3 grid(va::cdiv(W, va::TX), va::cdiv(H, va::TY), n_planes);
  if (k == 3)
    median_kernel<3><<<grid, block, 0, (cudaStream_t)stream>>>(
        in, out, H, W, planes_per_image, active);
  else if (k == 5)
    median_kernel<5><<<grid, block, 0, (cudaStream_t)stream>>>(
        in, out, H, W, planes_per_image, active);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
