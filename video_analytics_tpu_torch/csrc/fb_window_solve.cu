// fb_window_solve and fb_iteration: the window average of Farneback's five
// normal-equation planes along y and along x and the regularised 2x2 solve,
// in one launch; with fb_iteration the normal equations themselves are
// formed by the tile loader, so one launch is one whole iteration.
//
// Replaces, in video_analytics_tpu/ops/pallas/farneback_kernels.py,
// corr_solve_from_T_pallas (both window passes and the solve in one kernel)
// and the window-average and solve halves of _neq_corr_axis,
// warp_neq_corr_pallas, corr_solve_warp_from_T_pallas and
// farneback_level_pallas; fb_iteration is the whole of one iteration of
// farneback_level_pallas (kernel _level_kernel).
//
// What it computes, per pair and pixel (y, x), with n taps k, r = n / 2 and
// indices clamped to the plane (replicate border):
//   A(y, x) = k[0]*M(y - r, x) + k[1]*M(y - r + 1, x) + ...   (five planes)
//   S(y, x) = k[0]*A(y, x - r) + k[1]*A(y, x - r + 1) + ...
//   flow    = _solve_flow(S)          (flow/farneback.py), as (B, 2, h, w)
// each sum taken tap by tap in that order: what sep_corr.cu computes in two
// launches (along y, then along x with the solve), to the last bit.  The
// taps stay as the host makes them: the box window is fifteen taps of
// float32(1/15), not a running sum.  With fb_iteration M is not read but
// made: va::neq_pixel (fb_neq.cuh, the arithmetic of fb_warp_neq.cu) at
// the clamped coordinates of every element of the tile and its halo.
//
// Design.  One block of 256 threads makes a 32x32 tile of outputs, a plane
// at a time; a thread owns one run of four outputs along x and keeps its
// five sums in registers until the solve.
//   1. One plane's tile of M with a halo of r on both axes goes to shared
//      memory, coordinates clamped to the plane.  Because x is clamped
//      before the pass along y, a halo column outside the plane holds,
//      after that pass, the value of the clamped column: exactly what the
//      second of the two launches read there.  (fb_iteration makes all
//      five planes' tiles at once, before the first pass: the gather is
//      not repeated per plane.)
//   2. The pass along y, for the tile's 32 rows and all 32 + 2r columns,
//      into a second shared buffer: a thread makes four outputs of one
//      column from n + 3 loaded values, not 4n.
//   3. The pass along x from that buffer, four outputs of one row from
//      n + 3 values (read as 16-byte words: four-wide runs a lane would
//      otherwise put four lanes on one bank), into the thread's registers.
//   4. After the fifth plane, the solve and the store.
// The averaged planes never reach device memory (two launches wrote and
// read 5 planes between them), a tile reads (32 + 2r)/32 rows per output
// row where the 8-row tiles of sep_corr.cu read (8 + 2r)/8, and with a
// plane's two buffers at 15 KB (48 KB with fb_iteration's five tiles) four
// blocks share an SM, so one block's loads overlap another's passes; a
// 64-wide tile left the SMs idle while its few large blocks waited on their
// loads (twice the time at 224^2).  The default window's fifteen taps are
// known at compile time (both passes unrolled, the taps operands from the
// launch parameters, no tap read from shared memory); any other odd n takes
// the same kernel with loops over n, its taps copied from device memory to
// shared memory.  The buffers grow as (32 + 2r)^2: fb_iteration's five
// tiles fit a block's 227 KB up to r = 36 (winsize 73), fb_window_solve's
// one up to r = 96 (winsize 193); ops/cuda/farneback.window_route sends a
// longer window to sep_corr.cu's two passes.  Dynamic shared memory, opted
// in to.
//
// Bound on the H100: memory.  5 planes read and 2 written, 28 bytes a pixel
// for 2 x 2 x 5 x n + 12 operations (312 at the default window): at 15
// pairs of 224^2 21 MB, 6.3 us at 3.35 TB/s, against 3.5 us for the
// operations.  fb_iteration reads R0, R1 and the flow (12 planes) and
// writes 2: 56 bytes a pixel, 12.6 us.  Without FMA contraction a tap is
// two instructions: ~9 us of the schedulers' time at 224^2, above both.

#include "fb_neq.cuh"

namespace {

constexpr int WT = 32;                // tile width
constexpr int HT = 32;                // tile height
constexpr int WS_NT = 256;            // threads per block
constexpr int RUN = 4;                // outputs a thread makes at a time
static_assert(WT * HT == RUN * WS_NT, "one run along x per thread");
constexpr int MAX_SMEM = 232448;      // bytes a block may opt in to

// Row length of the buffer between the passes: a multiple of four floats,
// so a run's 16-byte reads are aligned.
__host__ __device__ inline int mid_stride(int r) {
  return (WT + 2 * r + 3) & ~3;
}

// The two buffers and the taps.
long long smem_bytes(int n, bool neq) {
  const long long r = n / 2;
  const long long tile = (HT + 2 * r) * (WT + 2 * r);
  return (HT * mid_stride((int)r) + (neq ? 5 : 1) * tile + n) *
         (long long)sizeof(float);
}

// RUN correlation sums out[j] = k[0]*v[j] + k[1]*v[j + 1] + ..., each taken
// tap by tap in that order, from the N + RUN - 1 values of v.
template <int N>
__device__ __forceinline__ void corr_static(const float* v,
                                            const va::Taps& taps,
                                            float out[RUN]) {
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    float a = taps.k[0] * v[j];
#pragma unroll
    for (int k = 1; k < N; ++k) a = a + taps.k[k] * v[j + k];
    out[j] = a;
  }
}

// The same sums for n taps known only at run time, src[i * stride] in the
// place of v[i], the taps from shared memory.
__device__ __forceinline__ void corr_dynamic(const float* src, int stride,
                                             const float* tk, int n,
                                             float out[RUN]) {
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    float a = 0.0f;
    for (int k = 0; k < n; ++k) {
      const float term = tk[k] * src[(j + k) * stride];
      a = k == 0 ? term : a + term;
    }
    out[j] = a;
  }
}

// NEQ: the loader forms M from (R0, R1, flow); else it reads M from a.
// N: the number of taps where the kernel is compiled for it, else 0.
template <bool NEQ, int N>
__global__ void __launch_bounds__(WS_NT, 4)
fb_window_solve_kernel(const float* __restrict__ a,
                       const float* __restrict__ R1,
                       const float* __restrict__ flow,
                       float* __restrict__ out, int h, int w, va::Taps taps,
                       const float* __restrict__ dtaps, va::BorderWeights bw) {
  extern __shared__ float4 sm4[];

  const int n = N > 0 ? N : taps.n;
  const int r = n / 2;
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * WT;
  const int y0 = blockIdx.y * HT;
  const int b = blockIdx.z;
  const size_t hw = (size_t)h * w;
  const int tw = WT + 2 * r;          // columns of the loaded tile
  const int th = HT + 2 * r;          // rows of the loaded tile
  const int tws = mid_stride(r);      // row length between the passes
  const int in_plane = th * tw;       // floats per plane of the loaded tile
  float* mid = reinterpret_cast<float*>(sm4);   // HT rows of tws
  float* tile = mid + HT * tws;       // one plane of th x tw, or five
  float* tk = tile + (NEQ ? 5 : 1) * in_plane;   // n taps, where N = 0

  if (N == 0)
    for (int i = tid; i < n; i += WS_NT) tk[i] = dtaps[i];
  if constexpr (NEQ) {
#pragma unroll 2
    for (int i = tid; i < in_plane; i += WS_NT) {
      const int ly = i / tw, lx = i - ly * tw;
      const int gy = min(max(y0 + ly - r, 0), h - 1);
      const int gx = min(max(x0 + lx - r, 0), w - 1);
      float m[5];
      va::neq_pixel(a + (size_t)b * 5 * hw, R1 + (size_t)b * 5 * hw,
                    flow + (size_t)b * 2 * hw, h, w, gy, gx, bw, m);
#pragma unroll
      for (int p = 0; p < 5; ++p) tile[p * in_plane + i] = m[p];
    }
  }

  // The thread's run: outputs xg * 4 .. xg * 4 + 3 of row ty of the tile.
  const int ty = tid / (WT / RUN), xg = tid - ty * (WT / RUN);
  float acc[RUN][5];
#pragma unroll
  for (int p = 0; p < 5; ++p) {
    const float* tp = tile;
    if constexpr (NEQ) {
      tp = tile + p * in_plane;
    } else {
      const float* in = a + ((size_t)b * 5 + p) * hw;
      for (int i = tid; i < in_plane; i += WS_NT) {
        const int ly = i / tw, lx = i - ly * tw;
        const int gy = min(max(y0 + ly - r, 0), h - 1);
        const int gx = min(max(x0 + lx - r, 0), w - 1);
        tile[i] = in[(size_t)gy * w + gx];
      }
    }
    // The tile is whole, and the pass along x of the plane before has
    // read what the pass along y now overwrites.
    __syncthreads();

    // Along y: rows 4g .. 4g + 3 of one column from rows 4g .. 4g + n + 2
    // of the loaded tile.
    for (int item = tid; item < (HT / RUN) * tw; item += WS_NT) {
      const int g = item / tw, col = item - g * tw;
      const float* src = tp + g * RUN * tw + col;
      float o[RUN];
      if constexpr (N > 0) {
        float v[N + RUN - 1];
#pragma unroll
        for (int i = 0; i < N + RUN - 1; ++i) v[i] = src[i * tw];
        corr_static<N>(v, taps, o);
      } else {
        corr_dynamic(src, tw, tk, n, o);
      }
#pragma unroll
      for (int j = 0; j < RUN; ++j) mid[(g * RUN + j) * tws + col] = o[j];
    }
    __syncthreads();

    // Along x: the thread's run of four outputs.
    {
      const float* src = mid + ty * tws + xg * RUN;
      float o[RUN];
      if constexpr (N > 0) {
        constexpr int NV = (N + RUN - 1 + 3) / 4;      // 16-byte words
        float4 v4[NV];
#pragma unroll
        for (int i = 0; i < NV; ++i)
          v4[i] = reinterpret_cast<const float4*>(src)[i];
        corr_static<N>(reinterpret_cast<const float*>(v4), taps, o);
      } else {
        corr_dynamic(src, 1, tk, n, o);
      }
#pragma unroll
      for (int j = 0; j < RUN; ++j) acc[j][p] = o[j];
    }
  }

  const int py = y0 + ty;
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    const int px = x0 + xg * RUN + j;
    if (px < w && py < h) {
      float* f = out + (size_t)b * 2 * hw + (size_t)py * w + px;
      va::solve_flow(acc[j], f, f + hw);
    }
  }
}

template <bool NEQ, int N>
int launch_n(const float* a, const float* R1, const float* flow, float* out,
             int B, int h, int w, const va::Taps& taps, const float* dtaps,
             int n, const va::BorderWeights& bw, cudaStream_t stream) {
  static int smem_set = 0;            // what this instantiation has opted in to
  if (smem_bytes(n, NEQ) > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int smem = (int)smem_bytes(n, NEQ);
  if (smem > smem_set) {              // above 48 KB a kernel must opt in
    cudaError_t err = cudaFuncSetAttribute(
        fb_window_solve_kernel<NEQ, N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
    smem_set = smem;
  }
  const dim3 grid(va::cdiv(w, WT), va::cdiv(h, HT), B);
  fb_window_solve_kernel<NEQ, N><<<grid, WS_NT, smem, stream>>>(
      a, R1, flow, out, h, w, taps, dtaps, bw);
  return (int)cudaGetLastError();
}

template <bool NEQ>
int launch(const float* a, const float* R1, const float* flow, float* out,
           int B, int h, int w, const float* taps, const float* dtaps, int n,
           const va::BorderWeights& bw, void* stream) {
  if (n < 1 || n % 2 != 1 || B < 1 || h < 1 || w < 1 || dtaps == nullptr)
    return (int)cudaErrorInvalidValue;
  const va::Taps t = va::make_taps(taps, n);
  const cudaStream_t s = (cudaStream_t)stream;
  if (n == 15)
    return launch_n<NEQ, 15>(a, R1, flow, out, B, h, w, t, dtaps, n, bw, s);
  return launch_n<NEQ, 0>(a, R1, flow, out, B, h, w, t, dtaps, n, bw, s);
}

}  // namespace

// Bytes of shared memory a block takes for n taps, or -1 above the 232,448
// a block may have (the launch refuses it).  neq: fb_iteration's five tiles.
VA_EXPORT int va_fb_window_smem(int n, int neq) {
  const long long bytes = smem_bytes(n, neq != 0);
  return bytes > MAX_SMEM ? -1 : (int)bytes;
}

// M: (B, 5, h, w) planes g11, g12, g22, h1, h2; out: (B, 2, h, w) flow.
// taps: n taps, n odd, on the host and (dtaps) in device memory, applied
// along y and then along x.
VA_EXPORT int va_fb_window_solve(const float* M, float* out, int B, int h,
                                 int w, const float* taps, const float* dtaps,
                                 int n, void* stream) {
  return launch<false>(M, nullptr, nullptr, out, B, h, w, taps, dtaps, n,
                       va::BorderWeights{}, stream);
}

// One whole iteration.  R0, R1: (B, 5, h, w) expansions; flow: (B, 2, h, w)
// current flow; out: (B, 2, h, w) new flow, a distinct buffer (a block
// reads the flow of its neighbours' tiles).  border: the five attenuation
// weights (host).  h, w >= 2.
VA_EXPORT int va_fb_iteration(const float* R0, const float* R1,
                              const float* flow, float* out, int B, int h,
                              int w, const float* border, const float* taps,
                              const float* dtaps, int n, void* stream) {
  if (h < 2 || w < 2) return (int)cudaErrorInvalidValue;
  return launch<true>(R0, R1, flow, out, B, h, w, taps, dtaps, n,
                      va::make_border(border), stream);
}
