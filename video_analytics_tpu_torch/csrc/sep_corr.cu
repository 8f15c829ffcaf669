// K-F sep_corr: 1-D correlation of (B, C, h, w) planes along one axis with
// a replicate border, and, as an epilogue for C = 5, Farneback's
// regularised 2x2 solve.
//
// Replaces video_analytics_tpu/ops/pallas/farneback_kernels.py:
// _sep_corr_axis and _sep_corr_axis_any (sep_corr2d_pallas,
// update_flow_pallas) and the window-average and solve halves of
// _neq_corr_axis, warp_neq_corr_pallas, corr_solve_from_T_pallas,
// corr_solve_warp_from_T_pallas and farneback_level_pallas.
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
// One Farneback iteration with a window beyond 193 taps is K-E, then this
// along y, then this along x with the epilogue (ops/cuda/farneback.
// window_route); fb_window_solve.cu takes the shorter windows.  The taps
// are kept as the host makes them (the box window is n taps of float32(1/n),
// not a running sum), each product rounds on its own (-fmad=false) and the
// sum starts from -0.0, which adds nothing to the first product, so the
// result equals the plain version's to the bit.  No tensor cores: the
// order of the sum and full float32 rule them out.
//
// Design.  At the window lengths this kernel takes the work is bound by
// operations, 2 a tap, output and plane (at 201 taps 804 against 8 bytes
// moved), so a thread makes R outputs along the axis, not one:
//   - A block is 32 lanes across the axis by 8 threads along it, each
//     thread R consecutive outputs along it: 32 x 8R outputs of P planes
//     (P = 1, or 5 with the epilogue, where one thread needs the five sums
//     of its pixels).
//   - The taps and the samples they reach go through shared memory in
//     chunks of CH taps, double-buffered with cp.async: while the block
//     sums one chunk, the next chunk's taps and its 8R + CH - 1 samples
//     along the axis (clamped coordinates) are on their way.
//     Shared memory is fixed by (P, R, CH), so no window is refused.
//   - A thread keeps R samples of each of its P planes in registers as
//     rings: per tap one broadcast load of the tap, one load a plane of
//     the sample that enters its ring, then P * R multiplies and P * R
//     adds (the ring index is known at compile time, the tap loop unrolled
//     by R; the P * R sums are independent, so the loads' latency hides).
//     Shared memory issues at a quarter of the FP32 lanes' rate; at R = 16
//     (P = 1) and R = 8 (P = 5) a load is one instruction in 17 or 14.
//   - A buffer is indexed so that a warp's 32 lanes read 32 distinct banks
//     along either axis: along y a sample row is 32 consecutive floats,
//     along x a lane's samples are a row of odd length 8R + CH - 1.
//   - A block reads ceil(n / CH) * (8R + CH - 1) samples along the axis for
//     its 8R outputs: at 201 taps and R = 16, CH = 64, 6 an output row
//     along y, where the 8-row tiles of the first version read 26.  A
//     chunk's samples overlap the next chunk's by 8R - 1, read again from
//     L2; longer chunks read fewer.
//   - Registering R outputs a thread cuts the threads a plane has R-fold.
//     Where the large-R grid would not give every SM two blocks (the 1/8
//     level of 1080p, 135 x 240, has 40 blocks along x with the solve),
//     the launch takes the same kernel at R = 4 (80 blocks there; R = 1
//     gave more blocks but was slower: a chunk's work at R = 1 is too
//     short to cover the next chunk's loads).
//   - A chunk with all its taps runs without the per-tap test that the
//     window's last, shorter chunk needs.
//   - Along x a lane's R outputs are consecutive in its row, stored 16
//     bytes at a time where the row allows.
//
// Bound on the H100: operations at the windows this kernel takes, 2 per
// tap, output and plane at 67 TFLOP/s: at 201 taps the 1/8 level of
// 1080p (135 x 240, 2 pairs, 5 planes) is 130 MFLOP, 1.9 us, and the
// 1080 x 1920 level 8.3 GFLOP, 124 us, against 50 us for its bytes (each
// input read once, each output written once: 8 bytes a pixel and plane,
// 28 with the epilogue's five planes in and two out).

#include <stdint.h>

#include "fb_neq.cuh"

namespace {

constexpr int TA = 8;                 // threads along the axis in a block
constexpr int LANES = 32;             // threads across it

// Taps a chunk holds: 64 for one plane at R = 16, else 32.  A chunk reads
// its 8R + CH - 1 samples from L2 anew, so a longer chunk reads fewer
// samples a tap, up to where its buffers crowd blocks off the SM.
template <int P, int R>
__host__ __device__ constexpr int chunk_taps() {
  return P == 1 && R == 16 ? 64 : 32;
}

// Samples along the axis a chunk of a block reads.
template <int P, int R>
__host__ __device__ constexpr int span() {
  return TA * R + chunk_taps<P, R>() - 1;
}

// Bytes of shared memory: two stages of P planes' samples and the taps.
template <int P, int R>
__host__ __device__ constexpr int smem_bytes() {
  return 2 * (P * span<P, R>() * LANES + chunk_taps<P, R>()) *
         (int)sizeof(float);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One chunk's taps into the sums: `count` taps (all CH where FULL) from tk,
// the samples from st (this thread's first, STEP floats apart along the
// axis, PLANE floats between planes).  The planes' rings side by side: one
// tap load serves P * R products, and P * R independent sums hide the
// loads' latency.
template <int P, int R, int CH, int STEP, int PLANE, bool FULL>
__device__ __forceinline__ void sum_chunk(float (&acc)[P][R],
                                          const float* st, const float* tk,
                                          int count) {
  float ring[P][R];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int j = 0; j < R; ++j) ring[p][j] = st[p * PLANE + j * STEP];
#pragma unroll
  for (int g = 0; g < CH; g += R) {
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int i = g + t;                         // tap within the chunk
      if (FULL || i < count) {
        const float k = tk[i];
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int j = 0; j < R; ++j)
            acc[p][j] = acc[p][j] + k * ring[p][(t + j) % R];
      }
      // Sample i + R enters the ring where sample i leaves it.
      if (i + R < CH + R - 1) {
#pragma unroll
        for (int p = 0; p < P; ++p)
          ring[p][t] = st[p * PLANE + (i + R) * STEP];
      }
    }
  }
}

// AXIS 0 correlates along y, 1 along x.  Along the axis the plane has
// `len` samples, across it `across`.
template <int P, bool SOLVE, int AXIS, int R>
__global__ void __launch_bounds__(LANES * TA)
sep_corr_kernel(const float* __restrict__ x, float* __restrict__ out, int h,
                int w, const float* __restrict__ taps, int n) {
  constexpr int CH = chunk_taps<P, R>();
  constexpr int SPAN = span<P, R>();
  constexpr int STAGE = P * SPAN * LANES + CH;    // floats of one stage
  static_assert(CH % R == 0, "the tap loop is unrolled by R");
  extern __shared__ float sm[];

  const int len = AXIS == 0 ? h : w;
  const int across = AXIS == 0 ? w : h;
  const int lane = threadIdx.x, ta = threadIdx.y;
  const int tid = ta * LANES + lane;
  const int c0 = blockIdx.x * LANES;               // first lane's position
  const int a0 = blockIdx.y * TA * R;              // first output along
  const size_t hw = (size_t)h * w;
  const float* in = x + (size_t)blockIdx.z * P * hw;
  const int r = n / 2;
  const int chunks = (n + CH - 1) / CH;

  // Stage q of plane p holds, along y, sample row a at a * 32 + lane and,
  // along x, lane c's samples as a row of SPAN at c * SPAN + a: a warp
  // reads 32 banks either way, and the global reads run along rows.
  auto load = [&](int q) {
    float* st = sm + (q & 1) * STAGE;
    const int first = a0 - r + q * CH;             // along, of sample 0
    if (AXIS == 0) {
      const int gc = min(c0 + lane, across - 1);
      for (int a = ta; a < SPAN; a += TA) {
        const float* src = in + (size_t)min(max(first + a, 0), len - 1) * w +
                           gc;
#pragma unroll
        for (int p = 0; p < P; ++p)
          cp_async4(st + p * SPAN * LANES + a * LANES + lane, src + p * hw);
      }
    } else {
      for (int c = ta; c < LANES; c += TA) {
        const float* row = in + (size_t)min(c0 + c, across - 1) * w;
        for (int a = lane; a < SPAN; a += LANES) {
          const float* src = row + min(max(first + a, 0), len - 1);
#pragma unroll
          for (int p = 0; p < P; ++p)
            cp_async4(st + p * SPAN * LANES + c * SPAN + a, src + p * hw);
        }
      }
    }
    if (tid < CH) cp_async4(st + P * SPAN * LANES + tid,
                            taps + min(q * CH + tid, n - 1));
  };

  float acc[P][R];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[p][j] = -0.0f;

  // This thread's first sample in a stage, and the step between samples.
  const int base = ta * R;                         // its first output along
  const int lane_off = AXIS == 0 ? lane : lane * SPAN;
  constexpr int STEP = AXIS == 0 ? LANES : 1;      // along, in the buffer

  load(0);
  cp_async_commit();
  for (int q = 0; q < chunks; ++q) {
    if (q + 1 < chunks) load(q + 1);
    cp_async_commit();
    cp_async_wait<1>();               // chunk q has landed
    __syncthreads();
    const float* st = sm + (q & 1) * STAGE + lane_off + base * STEP;
    const float* tk = sm + (q & 1) * STAGE + P * SPAN * LANES;
    const int count = min(CH, n - q * CH);
    if (count == CH)
      sum_chunk<P, R, CH, STEP, SPAN * LANES, true>(acc, st, tk, CH);
    else
      sum_chunk<P, R, CH, STEP, SPAN * LANES, false>(acc, st, tk, count);
    __syncthreads();                  // stage q & 1 is refilled next round
  }

  const int c = c0 + lane;
  if (c >= across) return;
  constexpr int Q = SOLVE ? 2 : P;                 // planes written
  float res[Q][R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if constexpr (SOLVE) {
      float sums[5];
#pragma unroll
      for (int p = 0; p < 5; ++p) sums[p] = acc[p][j];
      va::solve_flow(sums, &res[0][j], &res[1][j]);
    } else {
#pragma unroll
      for (int p = 0; p < P; ++p) res[p][j] = acc[p][j];
    }
  }
  float* dst = out + (size_t)blockIdx.z * Q * hw;
  const int a = a0 + base;
  if constexpr (AXIS == 1 && R % 4 == 0) {
    // Along x a lane's R outputs are consecutive in its row: 16-byte
    // stores where the row allows, where one float a lane would put each
    // of the warp's stores in 32 rows' sectors, an eighth of each filled.
    if ((w & 3) == 0 && ((uintptr_t)out & 15) == 0 && a + R <= len) {
#pragma unroll
      for (int p = 0; p < Q; ++p)
#pragma unroll
        for (int j = 0; j < R; j += 4)
          *reinterpret_cast<float4*>(dst + p * hw + (size_t)c * w + a + j) =
              make_float4(res[p][j], res[p][j + 1], res[p][j + 2],
                          res[p][j + 3]);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if (a + j >= len) break;
    const size_t o = AXIS == 0 ? (size_t)(a + j) * w + c
                               : (size_t)c * w + a + j;
#pragma unroll
    for (int p = 0; p < Q; ++p) dst[p * hw + o] = res[p][j];
  }
}

template <int P, bool SOLVE, int AXIS, int R>
int launch(const float* x, float* out, int h, int w, const float* taps, int n,
           int batches, cudaStream_t s) {
  static bool opted_in = false;       // above 48 KB a kernel must opt in
  constexpr int smem = smem_bytes<P, R>();
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        sep_corr_kernel<P, SOLVE, AXIS, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
    opted_in = true;
  }
  const int len = AXIS == 0 ? h : w, across = AXIS == 0 ? w : h;
  const dim3 grid(va::cdiv(across, LANES), va::cdiv(len, TA * R), batches);
  sep_corr_kernel<P, SOLVE, AXIS, R><<<grid, dim3(LANES, TA), smem, s>>>(
      x, out, h, w, taps, n);
  return (int)cudaGetLastError();
}

// Outputs along the axis a thread makes: 16 with one plane, 8 with five,
// where that grid gives every SM two blocks, else 4.
template <int P, bool SOLVE, int AXIS>
int launch_r(const float* x, float* out, int h, int w, const float* taps,
             int n, int batches, cudaStream_t s) {
  constexpr int BIG = P == 1 ? 16 : 8;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      return (int)cudaGetLastError();
  }
  const int len = AXIS == 0 ? h : w, across = AXIS == 0 ? w : h;
  auto blocks = [&](int R) {
    return (long long)va::cdiv(across, LANES) * va::cdiv(len, TA * R) *
           batches;
  };
  if (blocks(BIG) >= 2LL * sms)
    return launch<P, SOLVE, AXIS, BIG>(x, out, h, w, taps, n, batches, s);
  return launch<P, SOLVE, AXIS, 4>(x, out, h, w, taps, n, batches, s);
}

}  // namespace

// Bytes of shared memory a block of the kernel takes for `planes` (1, or
// 5 with the solve) at its largest R, the most of its forms, whatever the
// number of taps.
VA_EXPORT int va_sep_corr_smem(int planes) {
  if (planes == 1) return smem_bytes<1, 16>();
  if (planes == 5) return smem_bytes<5, 8>();
  return -1;
}

// x: (B, C, h, w); out: (B, C, h, w), or (B, 2, h, w) with solve (C = 5).
// taps: n taps in device memory, n odd, any length.  axis 0 correlates
// along y, axis 1 along x.
VA_EXPORT int va_sep_corr(const float* x, float* out, int B, int C, int h,
                          int w, const float* taps, int n, int axis,
                          int solve, void* stream) {
  if (n < 1 || n % 2 != 1 || (axis != 0 && axis != 1) || (solve && C != 5) ||
      taps == nullptr || h < 1 || w < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (solve)
    return axis == 0
               ? launch_r<5, true, 0>(x, out, h, w, taps, n, B, s)
               : launch_r<5, true, 1>(x, out, h, w, taps, n, B, s);
  return axis == 0 ? launch_r<1, false, 0>(x, out, h, w, taps, n, B * C, s)
                   : launch_r<1, false, 1>(x, out, h, w, taps, n, B * C, s);
}
