// K-G tvl1_pd_chunk: several TV-L1 primal-dual iterations per launch on
// shared-memory tiles, for planes too large for the per-iteration chain
// to be the right tool (native-resolution flow, e.g. 1080x1920).
//
// Replaces video_analytics_tpu/ops/pallas/tvl1_solve.py:_run_chunk and its
// kernel _dma_chunk_kernel (called from tvl1_solve_warp_banded).  It computes
// what that kernel computes, not its row bands and DMA windows.
//
// One launch advances every active band of every image by `iters`
// iterations of the step of tvl1_pd.cu (same arithmetic, same order):
//   rho = rho_c + I1wx*u + I1wy*v
//   d   = l_t if rho < -l_t*grad, -l_t if rho > l_t*grad,
//         else -rho / max(grad, 1e-10)
//   un  = u + d*I1wx + theta * div(p11, p12)   (vn likewise with p21, p22)
//   p  <- (p + taut*grad(un)) / (1 + taut*|grad(un)|)
// preceded, on the first chunk of an outer round, by the k x k median of
// u and v with replicate borders at the image's edges.
//
// Design.  The six state planes (u, v, p11, p12, p21, p22) cross device
// memory once per chunk instead of once per iteration:
//   - a thread block owns a T x T tile of one image and loads an S x S
//     window of all ten planes (S = T + 2*halo) into shared memory,
//     together with 1/max(grad, 1e-10), computed once per chunk;
//   - it then iterates the whole window in place.  un needs only its own
//     u and the dual of the pixel, its left and its upper neighbour; the
//     new dual needs only its own old value and un of the pixel, its right
//     and its lower neighbour.  So each iteration is two in-place phases
//     with a barrier after each, and no second copy of the window;
//   - values at the window's edge miss a neighbour and are wrong; the
//     error moves one pixel inwards per iteration (two more for a 5x5
//     median).  With halo >= iters + k/2 it never reaches the tile, whose
//     values equal those of iterating the whole plane, to the last bit;
//   - the image's true borders come from global coordinates: the forward
//     difference is 0 on the last row and column, the divergence passes
//     p through on the first, the median clamps its window to the image.
//     Pixels outside the image are never read into a result;
//   - the median reads raw u and v staged (with clamped coordinates) in
//     the shared-memory planes that the dual variables use afterwards;
//   - only the tile is written back, to a second buffer (neighbouring
//     blocks still read the old halo), so the wrapper ping-pongs;
//   - rows are grouped in gating bands of `band` rows.  A tile never
//     straddles a band edge: grid y = band index * tiles_per_band + tile
//     row in the band.  A block whose band's flag is 0 copies its tile
//     forward and reports 0 (tvl1_solve.py:844-848);
//   - on the chunk's last iteration each block sums (un-u)^2 + (vn-v)^2
//     over its tile, per thread and then in a fixed tree order, and writes
//     one float.  No float atomics: a run repeats bit for bit.
//
// Bound on the H100.  Per launch the function must read 10 planes and
// write 6 (64 B per pixel, 19 ps at 3.35 TB/s) for iters * ~70 float
// operations per pixel (1 ps per iteration at 67 TFLOP/s): bytes are the
// larger term below 18 iterations per launch.  This kernel reads (S/T)^2
// times the pixels it writes and iterates all of the window.  Keeping each
// thread's own pixels in registers (only neighbours need shared memory)
// and shrinking the iterated region as the error moves in are later
// tuning work.

#include "common.cuh"
#include "median_network.h"

namespace {

constexpr int CX = 32;               // threads along a row: one warp
constexpr int CY = 32;
constexpr int CNT = CX * CY;         // 1024 threads
constexpr int N_SMEM_PLANES = 11;    // 6 state, 4 constants, 1/grad

struct ChunkGeom {
  int H, W;
  int band;         // rows per gating band
  int n_bands;      // cdiv(H, band)
  int tiles_band;   // tile rows per band: cdiv(band, T)
  int T;            // tile side
  int S;            // window side: T + 2 * halo
  int halo;
  int iters;
  int median_k;     // 0 (no median in this chunk), 3 or 5
};

template <int K>
__device__ __forceinline__ float window_median(const float* __restrict__ st,
                                               int S, int r, int c) {
  constexpr int R = K / 2;
  float w[K * K];
#pragma unroll
  for (int dy = 0; dy < K; ++dy)
#pragma unroll
    for (int dx = 0; dx < K; ++dx)
      w[dy * K + dx] = st[(r - R + dy) * S + (c - R + dx)];
  if constexpr (K == 3) {
    return va_median9(w);
  } else {
    return va_median25(w);
  }
}

__global__ void __launch_bounds__(CNT, 1)
pd_chunk_kernel(const float* __restrict__ prep,
                const float* __restrict__ state_in,
                float* __restrict__ state_out, const int* __restrict__ act,
                float* __restrict__ partial, ChunkGeom g, float l_t,
                float theta, float taut) {
  extern __shared__ float sm[];
  const int H = g.H, W = g.W, S = g.S, SS = g.S * g.S;
  const size_t hw = (size_t)H * W;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * CX + tx;
  const int b = blockIdx.z;
  const int band_i = blockIdx.y / g.tiles_band;
  const int y0 = band_i * g.band + (blockIdx.y % g.tiles_band) * g.T;
  const int y1 = min(min(y0 + g.T, (band_i + 1) * g.band), H);
  const int x0 = blockIdx.x * g.T;
  const int x1 = min(x0 + g.T, W);
  float* my_partial =
      partial + ((size_t)b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  const float* sin_g = state_in + (size_t)b * 6 * hw;
  float* sout_g = state_out + (size_t)b * 6 * hw;

  if (y0 >= y1) {  // a tile row past the band's or the image's end
    if (tid == 0) *my_partial = 0.0f;
    return;
  }
  if (!act[b * g.n_bands + band_i]) {  // uniform: frozen band, copy forward
    for (int y = y0 + ty; y < y1; y += CY)
      for (int x = x0 + tx; x < x1; x += CX) {
        const size_t o = (size_t)y * W + x;
#pragma unroll
        for (int k = 0; k < 6; ++k) sout_g[k * hw + o] = sin_g[k * hw + o];
      }
    if (tid == 0) *my_partial = 0.0f;
    return;
  }

  float* su = sm;
  float* sv = sm + SS;
  float* sp = sm + 2 * SS;           // p11, p12, p21, p22
  float* swx = sm + 6 * SS;
  float* swy = sm + 7 * SS;
  float* sgr = sm + 8 * SS;
  float* srho = sm + 9 * SS;
  float* sinv = sm + 10 * SS;
  float* red = sm + N_SMEM_PLANES * SS;   // CNT floats
  const float* prep_g = prep + (size_t)b * 4 * hw;
  const int oy = y0 - g.halo, ox = x0 - g.halo;
  const bool med = g.median_k > 1;

  // The constants, and either the state or (before a median) raw u and v
  // at clamped coordinates, staged where p11 and p12 will live.
  for (int r = ty; r < S; r += CY)
    for (int c = tx; c < S; c += CX) {
      const int gy = oy + r, gx = ox + c, i = r * S + c;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const size_t o = (size_t)gy * W + gx;
      const float gr = in ? prep_g[2 * hw + o] : 0.0f;
      swx[i] = in ? prep_g[o] : 0.0f;
      swy[i] = in ? prep_g[hw + o] : 0.0f;
      sgr[i] = gr;
      srho[i] = in ? prep_g[3 * hw + o] : 0.0f;
      sinv[i] = 1.0f / fmaxf(gr, 1e-10f);
      if (med) {
        const size_t oc = (size_t)min(max(gy, 0), H - 1) * W +
                          min(max(gx, 0), W - 1);
        sp[i] = sin_g[oc];
        sp[SS + i] = sin_g[hw + oc];
      } else {
#pragma unroll
        for (int k = 0; k < 6; ++k) sm[k * SS + i] = in ? sin_g[k * hw + o] : 0.0f;
      }
    }
  __syncthreads();
  if (med) {
    const int R = g.median_k / 2;
    for (int r = ty; r < S; r += CY)
      for (int c = tx; c < S; c += CX) {
        const int i = r * S + c;
        if (r < R || r >= S - R || c < R || c >= S - R) {
          su[i] = sp[i];               // window leaves the tile: in the halo
          sv[i] = sp[SS + i];
        } else if (g.median_k == 3) {
          su[i] = window_median<3>(sp, S, r, c);
          sv[i] = window_median<3>(sp + SS, S, r, c);
        } else {
          su[i] = window_median<5>(sp, S, r, c);
          sv[i] = window_median<5>(sp + SS, S, r, c);
        }
      }
    __syncthreads();
    for (int r = ty; r < S; r += CY)
      for (int c = tx; c < S; c += CX) {
        const int gy = oy + r, gx = ox + c, i = r * S + c;
        const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
        const size_t o = (size_t)gy * W + gx;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          sp[k * SS + i] = in ? sin_g[(2 + k) * hw + o] : 0.0f;
      }
    __syncthreads();
  }

  const int ry1 = g.halo + (y1 - y0), rx1 = g.halo + (x1 - x0);
  float e = 0.0f;
  for (int it = 0; it < g.iters; ++it) {
    const bool last = it == g.iters - 1;
    // Phase A: (u, v) <- (un, vn), in place.
    for (int r = ty; r < S; r += CY)
      for (int c = tx; c < S; c += CX) {
        const int gy = oy + r, gx = ox + c, i = r * S + c;
        if (gy < 0 || gy >= H || gx < 0 || gx >= W) continue;
        const float wx = swx[i], wy = swy[i];
        const float uu = su[i], vv = sv[i];
        const float rho = srho[i] + wx * uu + wy * vv;
        const float th = l_t * sgr[i];
        const float d = rho < -th ? l_t : (rho > th ? -l_t : -rho * sinv[i]);
        const float v1 = uu + d * wx;
        const float v2 = vv + d * wy;
        const float p11 = sp[i], p12 = sp[SS + i];
        const float p21 = sp[2 * SS + i], p22 = sp[3 * SS + i];
        // A neighbour outside the window reads as 0: such a value is in
        // the halo's outer ring, which no result depends on.
        const float d11 = gx == 0 ? p11 : p11 - (c > 0 ? sp[i - 1] : 0.0f);
        const float d12 = gy == 0 ? p12 : p12 - (r > 0 ? sp[SS + i - S] : 0.0f);
        const float d21 =
            gx == 0 ? p21 : p21 - (c > 0 ? sp[2 * SS + i - 1] : 0.0f);
        const float d22 =
            gy == 0 ? p22 : p22 - (r > 0 ? sp[3 * SS + i - S] : 0.0f);
        const float un = v1 + theta * (d11 + d12);
        const float vn = v2 + theta * (d21 + d22);
        if (last && r >= g.halo && r < ry1 && c >= g.halo && c < rx1) {
          const float du = un - uu, dv = vn - vv;
          e += du * du + dv * dv;
        }
        su[i] = un;
        sv[i] = vn;
      }
    __syncthreads();
    // Phase B: the dual variables from the forward gradient of (un, vn).
    for (int r = ty; r < S; r += CY)
      for (int c = tx; c < S; c += CX) {
        const int gy = oy + r, gx = ox + c, i = r * S + c;
        if (gy < 0 || gy >= H || gx < 0 || gx >= W) continue;
        const float un = su[i], vn = sv[i];
        const bool right = c + 1 < S, below = r + 1 < S;
        const float ux = gx < W - 1 ? (right ? su[i + 1] : 0.0f) - un : 0.0f;
        const float uy = gy < H - 1 ? (below ? su[i + S] : 0.0f) - un : 0.0f;
        const float vx = gx < W - 1 ? (right ? sv[i + 1] : 0.0f) - vn : 0.0f;
        const float vy = gy < H - 1 ? (below ? sv[i + S] : 0.0f) - vn : 0.0f;
        const float inv_u = 1.0f / (1.0f + taut * sqrtf(ux * ux + uy * uy));
        const float inv_v = 1.0f / (1.0f + taut * sqrtf(vx * vx + vy * vy));
        sp[i] = (sp[i] + taut * ux) * inv_u;
        sp[SS + i] = (sp[SS + i] + taut * uy) * inv_u;
        sp[2 * SS + i] = (sp[2 * SS + i] + taut * vx) * inv_v;
        sp[3 * SS + i] = (sp[3 * SS + i] + taut * vy) * inv_v;
      }
    __syncthreads();
  }

  for (int r = g.halo + ty; r < ry1; r += CY)
    for (int c = g.halo + tx; c < rx1; c += CX) {
      const size_t o = (size_t)(oy + r) * W + (ox + c);
      const int i = r * S + c;
#pragma unroll
      for (int k = 0; k < 6; ++k) sout_g[k * hw + o] = sm[k * SS + i];
    }

  red[tid] = e;
  __syncthreads();
  for (int s = CNT / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  if (tid == 0) *my_partial = red[0];
}

}  // namespace

// Bytes of dynamic shared memory a block of window side S needs.
VA_EXPORT int va_pd_chunk_smem(int S) {
  return (N_SMEM_PLANES * S * S + CNT) * (int)sizeof(float);
}

// prep: (B, 4, H, W) I1wx, I1wy, grad, rho_c; state_in/state_out:
// (B, 6, H, W) u, v, p11, p12, p21, p22, distinct buffers; act:
// (B, cdiv(H, band)) int32, one flag per gating band; partial:
// (B, n_bands * cdiv(band, T), cdiv(W, T)) one error sum per block (0 from
// a frozen block).  halo >= iters + median_k / 2; median_k in {0, 3, 5}.
VA_EXPORT int va_pd_chunk(const float* prep, const float* state_in,
                          float* state_out, const int* act, float* partial,
                          int B, int H, int W, int band, int T, int halo,
                          int iters, int median_k, float l_t, float theta,
                          float taut, void* stream) {
  if (iters < 1 || T < 1 || band < 1 ||
      (median_k != 0 && median_k != 3 && median_k != 5) ||
      halo < iters + median_k / 2)
    return (int)cudaErrorInvalidValue;
  ChunkGeom g;
  g.H = H;
  g.W = W;
  g.band = band;
  g.n_bands = va::cdiv(H, band);
  g.tiles_band = va::cdiv(band, T);
  g.T = T;
  g.S = T + 2 * halo;
  g.halo = halo;
  g.iters = iters;
  g.median_k = median_k;
  const int smem = va_pd_chunk_smem(g.S);
  // Above 48 KB a kernel must opt in to its dynamic shared memory.
  cudaError_t err = cudaFuncSetAttribute(
      pd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch must not see it
    return (int)err;
  }
  const dim3 block(CX, CY);
  const dim3 grid(va::cdiv(W, T), g.n_bands * g.tiles_band, B);
  pd_chunk_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      prep, state_in, state_out, act, partial, g, l_t, theta, taut);
  return (int)cudaGetLastError();
}
