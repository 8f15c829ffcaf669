// K-C median5: k x k median (k = 3 or 5) of flow planes, replicate border,
// with an optional per-image mask.
//
// Replaces the in-kernel median of video_analytics_tpu/ops/pallas/
// tvl1_solve.py (_median_network, _median2d in _solver_kernel, _median2d_xi
// in _pd_solve_packed and _scale_kernel_packed, _median2d_global) and the
// scale-end median of flow/tvl1.py (ops/median.median_filter2d, XLA in the
// reference).
//
// Design.  A thread makes a column of 8 outputs, not one.  The medians of
// the column come from one schedule of min/max operations over the
// column's 12 x k inputs (k = 5; 10 x 3 at k = 3): the separable,
// forgetful scheme of A. Adams, "Fast median filters using separable
// sorting networks" (ACM TOG 40(4), 2021), generated from
// ops/median.separable_median_schedule at build time (va_median_tile5 and
// va_median_tile3 in median_network.h, see ops/cuda/_build.py), so there
// is one source of truth.  Row segments are sorted once, the part every
// window of the column covers is merged once, and the column is halved
// down to single outputs, each half merging only what its windows add and
// forgetting the ranks that can be no window's median.  Per output that is
// 71.25 min/max at k = 5 (570 for the 8), against 226 (113
// compare-exchanges) for the pruned Batcher network that each thread ran
// on its own 25 values before; 18.5 against 48 at k = 3.  The tile was
// picked by that count and by what a thread holds: 60 inputs in registers
// (8 x 2 would need 72 for 64.9 an output), each read once from shared
// memory, where the one-output thread read 25 a pixel.
//
// A block of 32 x 4 threads makes a 32 x 32 tile of outputs: small blocks,
// so one block's loads overlap others' selection and the last wave is
// short.  The tile and its halo of k/2 go to shared memory once, at
// clamped coordinates (the replicate border), as 16-byte loads where a
// row's four floats lie inside the plane and W is a multiple of four, else
// one float at a time.  A warp's reads of its inputs and its stores are on
// 32 consecutive columns.
// The median of k^2 values does not depend on the network, so the result
// equals the plain version (ops/median.median_filter2d) by value.
//
// With a mask (`active`, one int per image; image = plane / planes_per_
// image), blocks of a masked-off image copy their tile through unchanged,
// 16 bytes at a time where they can: the TV-L1 solver filters only the
// images that have not converged.
//
// Bound on the H100: the bytes, now.  Each output reads one float and
// writes one (8 bytes, with a halo of 4/32 rows and 8/32 columns read
// again from L2), against 71.25 min/max at k = 5: at 224^2, 15 pairs, 2
// planes, 12 MB in 3.6 us at 3.35 TB/s against 107 MFLOP in 1.6 us at
// 67 TFLOP/s (226 a pixel, the old network, took 5.1 us).

#include <stdint.h>

#include "common.cuh"
#include "median_network.h"

namespace {

constexpr int TH = VA_MEDIAN_TILE_ROWS;     // outputs of a thread, a column
static_assert(VA_MEDIAN_TILE_COLS == 1, "median.cu makes a column a thread");
constexpr int TYM = 4;                      // threads: 32 x 4
constexpr int NTM = va::TX * TYM;
constexpr int BW = va::TX;                  // block tile: 32 columns
constexpr int BH = TYM * TH;                //   x 32 rows
constexpr int SW = BW + 8;                  // columns x0 - 4 .. x0 + BW + 3

template <int K>
__device__ __forceinline__ void median_tile(const float* v, float* o);

template <>
__device__ __forceinline__ void median_tile<3>(const float* v, float* o) {
  va_median_tile3(v, o);
}

template <>
__device__ __forceinline__ void median_tile<5>(const float* v, float* o) {
  va_median_tile5(v, o);
}

template <int K>
__global__ void __launch_bounds__(NTM)
median_kernel(const float* __restrict__ in, float* __restrict__ out, int H,
              int W, int planes_per_image, const int* __restrict__ active) {
  constexpr int R = K / 2;
  constexpr int SH = BH + 2 * R;
  __shared__ __align__(16) float tile[SH][SW];
  const int plane = blockIdx.z;
  const size_t hw = (size_t)H * W;
  const float* src = in + (size_t)plane * hw;
  float* dst = out + (size_t)plane * hw;
  const int tid = threadIdx.y * va::TX + threadIdx.x;
  const int x0 = blockIdx.x * BW, y0 = blockIdx.y * BH;
  // 16-byte words: rows of a multiple of four floats, 16-byte aligned.
  const bool wide = (W & 3) == 0 && ((uintptr_t)in & 15) == 0 &&
                    ((uintptr_t)out & 15) == 0;

  if (active != nullptr && !active[plane / planes_per_image]) {
    for (int i = tid; i < BH * (BW / 4); i += NTM) {
      const int y = y0 + i / (BW / 4), x = x0 + 4 * (i % (BW / 4));
      if (y >= H) continue;
      const size_t o = (size_t)y * W + x;
      if (wide && x + 3 < W) {
        *reinterpret_cast<float4*>(dst + o) =
            *reinterpret_cast<const float4*>(src + o);
      } else {
        for (int e = 0; e < 4 && x + e < W; ++e) dst[o + e] = src[o + e];
      }
    }
    return;
  }
  for (int i = tid; i < SH * (SW / 4); i += NTM) {
    const int r = i / (SW / 4), c = 4 * (i % (SW / 4));
    const int gy = min(max(y0 - R + r, 0), H - 1);
    const int gx = x0 - 4 + c;
    const float* row = src + (size_t)gy * W;
    if (wide && gx >= 0 && gx + 3 < W) {
      *reinterpret_cast<float4*>(&tile[r][c]) =
          *reinterpret_cast<const float4*>(row + gx);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tile[r][c + e] = row[min(max(gx + e, 0), W - 1)];
    }
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y * TH;
  if (x >= W || y >= H) return;
  float v[(TH + 2 * R) * K];
#pragma unroll
  for (int r = 0; r < TH + 2 * R; ++r)
#pragma unroll
    for (int c = 0; c < K; ++c)
      v[r * K + c] = tile[threadIdx.y * TH + r][threadIdx.x + 4 - R + c];
  float o[TH];
  median_tile<K>(v, o);
#pragma unroll
  for (int i = 0; i < TH; ++i)
    if (y + i < H) dst[(size_t)(y + i) * W + x] = o[i];
}

}  // namespace

// in/out: n_planes planes of (H, W), distinct buffers; k in {3, 5};
// active: null, or one int per image of planes_per_image planes.
VA_EXPORT int va_median(const float* in, float* out, int n_planes,
                        int planes_per_image, int H, int W, int k,
                        const int* active, void* stream) {
  const dim3 block(va::TX, TYM);
  const dim3 grid(va::cdiv(W, BW), va::cdiv(H, BH), n_planes);
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
