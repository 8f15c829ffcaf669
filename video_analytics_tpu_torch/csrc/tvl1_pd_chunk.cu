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
//   - a thread block owns a T x T tile of one image and works on the S x S
//     window around it (S = T + 2*halo <= 64), laid out on a fixed 64 x 64
//     grid.  Its 256 threads each own 16 pixels of that grid for the whole
//     chunk (column tid % 64, rows tid / 64 + 4k) and keep those pixels'
//     constants in registers: I1wx, I1wy, rho_c, l_t*grad and
//     1/max(grad, 1e-10), 80 registers of the 128 a thread may have.  Shared
//     memory holds only the six state planes, 96 KB, so two blocks share an
//     SM and one's window load overlaps the other's iterations.  (The state
//     of a thread's own pixels does not fit in registers as well: two
//     windows of 11 values a pixel are 90 K registers, the SM has 64 K.)
//   - each iteration is two in-place phases with a barrier after each.  un
//     needs only its own u and the dual of the pixel, its left and its upper
//     neighbour; the new dual needs only its own old value and un of the
//     pixel, its right and its lower neighbour.  No second copy of the window;
//   - values at the window's edge miss a neighbour and are wrong; the
//     error moves one pixel inwards per iteration (two more for a 5x5
//     median).  With halo >= iters + k/2 it never reaches the tile, whose
//     values equal those of iterating the whole plane, to the last bit.
//     Conversely, with n iterations to go only the pixels within n of the
//     tile can still reach a result: phase A keeps its values on the tile
//     and n rings around it, phase B on n - 1, the median runs on the first
//     phase A's region.  In the iterations the region only gates the
//     stores: a thread's pixels are fixed, so columns outside would only
//     idle lanes, and skipping rows by whole warps put a branch between a
//     thread's pixels, which cost more than the rows saved (0.47 ms a
//     launch at 1080x1920 with the branches, see PERF.md);
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
//     forward (tvl1_solve.py:844-848), unless the band was frozen in the
//     launch before as well (`prev_act`): then both buffers already hold
//     the same rows and the block returns at once;
//   - with `partial`, on the chunk's last iteration each block sums
//     (un-u)^2 + (vn-v)^2 over its tile, per thread, then a shuffle tree,
//     then the warps in turn, and writes one float (0 from a frozen block).
//     No float atomics: a run repeats bit for bit;
//   - with the round's test (`BandTest`, on the round's last launch) the
//     convergence test of the bands runs in the same launch, as the
//     CUDA samples' threadFenceReduction does it (va::arrive): every block
//     of image b, whatever path it took, writes its partial and counts
//     itself in count[b]; the block that arrives last sums each band's
//     partials in a fixed order (a warp a band, lanes strided, a shuffle
//     tree, then thread 0 over the bands), applies the image's and the
//     bands' tests, writes err_band and the next round's flags, and sets
//     count[b] back to 0.  The test is a function of its own, called
//     only there, in an instantiation of the kernel of its own, so the
//     other launches of a round keep the iterations' code unchanged.
//
// Bound on the H100.  Per launch the function must read 10 planes and
// write 6 (64 B per pixel, 19 ps at 3.35 TB/s) for iters * ~70 float
// operations per pixel (1 ps per iteration at 67 TFLOP/s): bytes are the
// larger term below 18 iterations per launch.  This kernel reads (S/T)^2
// times the pixels it writes.

#include "common.cuh"
#include "median_network.h"


namespace {

constexpr int GS = 64;               // side of the window grid; its row stride
constexpr int GNT = 256;             // threads per block
constexpr int GROWS = GNT / GS;      // grid rows the threads cover at once: 4
constexpr int GPPT = GS / GROWS;     // pixels a thread owns: 16
constexpr int GNW = GNT / 32;        // warps per block
constexpr int PLANE = GS * GS;
constexpr int N_SMEM_PLANES = 6;     // u, v, p11, p12, p21, p22

struct ChunkGeom {
  int H, W;
  int band;         // rows per gating band
  int n_bands;      // cdiv(H, band)
  int tiles_band;   // tile rows per band: cdiv(band, T)
  int T;            // tile side
  int S;            // window side: T + 2 * halo, at most GS
  int halo;
  int iters;
  int median_k;     // 0 (no median in this chunk), 3 or 5
};

// The round's convergence test, run by the last block of each image.
struct BandTest {
  int* count;       // (B,) blocks arrived, 0 between launches; null: no test
  float* err_band;  // (B, n_bands) each band's summed squared update
  int* act_next;    // (B, n_bands) the next round's flags
  float n_px;       // H * W
  float eps2;
  int adaptive;
};

template <int K>
__device__ __forceinline__ float window_median(const float* __restrict__ st,
                                               int i) {
  constexpr int R = K / 2;
  float w[K * K];
#pragma unroll
  for (int dy = 0; dy < K; ++dy)
#pragma unroll
    for (int dx = 0; dx < K; ++dx)
      w[dy * K + dx] = st[i + (dy - R) * GS + (dx - R)];
  if constexpr (K == 3) {
    return va_median9(w);
  } else {
    return va_median25(w);
  }
}

// `iters` iterations of one tile, and its partial.  Its returns end the
// block's work on the state; the test that may follow needs every block.
__device__ __forceinline__ void
pd_chunk_tile(const float* __restrict__ prep,
              const float* __restrict__ state_in,
              float* __restrict__ state_out, const int* __restrict__ act,
              const int* __restrict__ prev_act, float* __restrict__ partial,
              const ChunkGeom& g, float l_t, float theta, float taut,
              float* sm) {
  const int H = g.H, W = g.W, S = g.S;
  const size_t hw = (size_t)H * W;
  const int tid = threadIdx.x, tx = tid % GS, ty = tid / GS;
  const int b = blockIdx.z;
  const int band_i = blockIdx.y / g.tiles_band;
  const int y0 = band_i * g.band + (blockIdx.y % g.tiles_band) * g.T;
  const int y1 = min(min(y0 + g.T, (band_i + 1) * g.band), H);
  const int x0 = blockIdx.x * g.T;
  const int x1 = min(x0 + g.T, W);
  float* my_partial =
      partial == nullptr
          ? nullptr
          : partial + ((size_t)b * gridDim.y + blockIdx.y) * gridDim.x +
                blockIdx.x;
  const float* sin_g = state_in + (size_t)b * 6 * hw;
  float* sout_g = state_out + (size_t)b * 6 * hw;

  if (y0 >= y1) {  // a tile row past the band's or the image's end
    if (my_partial != nullptr && tid == 0) *my_partial = 0.0f;
    return;
  }
  const int flag = b * g.n_bands + band_i;
  if (!act[flag]) {  // uniform: a frozen band
    // Frozen in the launch before too: that launch copied these rows from
    // the buffer this one would write, so both hold them already.
    if (prev_act == nullptr || prev_act[flag]) {
      for (int y = y0 + ty; y < y1; y += GROWS)
        for (int x = x0 + tx; x < x1; x += GS) {
          const size_t o = (size_t)y * W + x;
#pragma unroll
          for (int k = 0; k < 6; ++k) sout_g[k * hw + o] = sin_g[k * hw + o];
        }
    }
    if (my_partial != nullptr && tid == 0) *my_partial = 0.0f;
    return;
  }

  float* su = sm;
  float* sv = sm + PLANE;
  float* sp = sm + 2 * PLANE;        // p11, p12, p21, p22
  float* red = sm + N_SMEM_PLANES * PLANE;   // GNW floats
  const float* prep_g = prep + (size_t)b * 4 * hw;
  const int halo = g.halo, iters = g.iters;
  const int oy = y0 - halo, ox = x0 - halo;
  const int th_ = y1 - y0, tw_ = x1 - x0;    // the tile's rows and columns
  const bool med = g.median_k > 1;
  // This thread's column, and the window's rows, inside the image.
  const int gx = ox + tx;
  const bool col_win = tx < S;
  const bool col_in = col_win && gx >= 0 && gx < W;
  const int rimg0 = max(0, -oy), rimg1 = min(S, H - oy);

  // The constants of this thread's pixels, and either the state or (before
  // a median) raw u and v at clamped coordinates, staged where p11 and p12
  // will live.
  float cwx[GPPT], cwy[GPPT], crho[GPPT], cth[GPPT], cinv[GPPT];
#pragma unroll
  for (int k = 0; k < GPPT; ++k) {
    const int r = ty + GROWS * k, i = r * GS + tx;
    const bool in = col_in && r >= rimg0 && r < rimg1;
    const size_t o = in ? (size_t)(oy + r) * W + gx : 0;
    const float gr = in ? prep_g[2 * hw + o] : 0.0f;
    cwx[k] = in ? prep_g[o] : 0.0f;
    cwy[k] = in ? prep_g[hw + o] : 0.0f;
    crho[k] = in ? prep_g[3 * hw + o] : 0.0f;
    cth[k] = l_t * gr;
    cinv[k] = 1.0f / fmaxf(gr, 1e-10f);
    if (!col_win || r >= S) continue;
    if (med) {
      const size_t oc = (size_t)min(max(oy + r, 0), H - 1) * W +
                        min(max(gx, 0), W - 1);
      sp[i] = sin_g[oc];
      sp[PLANE + i] = sin_g[hw + oc];
    } else {
#pragma unroll
      for (int q = 0; q < 6; ++q)
        sm[q * PLANE + i] = in ? sin_g[q * hw + o] : 0.0f;
    }
  }
  __syncthreads();
  if (med) {
    // Wanted where the first phase A runs: the tile and `iters` rings.
    const int r0 = max(halo - iters, rimg0);
    const int r1 = min(halo + th_ + iters, rimg1);
    const bool col = col_in && tx >= halo - iters && tx < halo + tw_ + iters;
#pragma unroll 1
    for (int k = 0; k < GPPT; ++k) {
      const int r = ty + GROWS * k, i = r * GS + tx;
      if (!col || r < r0 || r >= r1) continue;
      if (g.median_k == 3) {
        su[i] = window_median<3>(sp, i);
        sv[i] = window_median<3>(sp + PLANE, i);
      } else {
        su[i] = window_median<5>(sp, i);
        sv[i] = window_median<5>(sp + PLANE, i);
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < GPPT; ++k) {
      const int r = ty + GROWS * k, i = r * GS + tx;
      if (!col_win || r >= S) continue;
      const bool in = col_in && r >= rimg0 && r < rimg1;
      const size_t o = in ? (size_t)(oy + r) * W + gx : 0;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        sp[q * PLANE + i] = in ? sin_g[(2 + q) * hw + o] : 0.0f;
    }
    __syncthreads();
  }

  // In the iterations every load is in bounds whatever the pixel (the six
  // planes are one array; the first two have no upper or left reader, the
  // last four no lower or right one), the edges are selects, and only the
  // stores are predicated:
  // no branch separates a thread's pixels, so the compiler interleaves them.
  // A neighbour outside the window or the image is read but never selected
  // into a result that is kept.
  const bool x_first = gx == 0, x_last = gx >= W - 1;
  float e = 0.0f;
  for (int it = 0; it < iters; ++it) {
    const int m = iters - it;          // iterations to go, this one included
    const bool sum_e = my_partial != nullptr && m == 1;
    // Phase A: (u, v) <- (un, vn), in place, on the tile and m rings.
    {
      const int r0 = max(halo - m, rimg0);
      const int r1 = min(halo + th_ + m, rimg1);
      const bool col = col_in && tx >= halo - m && tx < halo + tw_ + m;
#pragma unroll
      for (int k = 0; k < GPPT; ++k) {
        const int r = ty + GROWS * k, i = r * GS + tx;
        const bool y_first = oy + r == 0;
        const float wx = cwx[k], wy = cwy[k];
        const float uu = su[i], vv = sv[i];
        const float p11 = sp[i], p12 = sp[PLANE + i];
        const float p21 = sp[2 * PLANE + i], p22 = sp[3 * PLANE + i];
        const float l11 = sp[i - 1], a12 = sp[PLANE + i - GS];
        const float l21 = sp[2 * PLANE + i - 1], a22 = sp[3 * PLANE + i - GS];
        const float rho = crho[k] + wx * uu + wy * vv;
        const float th = cth[k];
        const float d = rho < -th ? l_t : (rho > th ? -l_t : -rho * cinv[k]);
        const float v1 = uu + d * wx;
        const float v2 = vv + d * wy;
        const float d11 = x_first ? p11 : p11 - l11;
        const float d12 = y_first ? p12 : p12 - a12;
        const float d21 = x_first ? p21 : p21 - l21;
        const float d22 = y_first ? p22 : p22 - a22;
        const float un = v1 + theta * (d11 + d12);
        const float vn = v2 + theta * (d21 + d22);
        if (sum_e) {                   // uniform
          const float du = un - uu, dv = vn - vv;
          const bool tile = r >= halo && r < halo + th_ && tx >= halo &&
                            tx < halo + tw_;
          e += tile ? du * du + dv * dv : 0.0f;
        }
        if (col && r >= r0 && r < r1) {
          su[i] = un;
          sv[i] = vn;
        }
      }
    }
    __syncthreads();
    // Phase B: the dual variables from the forward gradient of (un, vn),
    // on the tile and m - 1 rings.
    {
      const int r0 = max(halo - (m - 1), rimg0);
      const int r1 = min(halo + th_ + (m - 1), rimg1);
      const bool col =
          col_in && tx >= halo - (m - 1) && tx < halo + tw_ + (m - 1);
#pragma unroll
      for (int k = 0; k < GPPT; ++k) {
        const int r = ty + GROWS * k, i = r * GS + tx;
        const bool y_last = oy + r >= H - 1;
        const float un = su[i], vn = sv[i];
        const float ru = su[i + 1], bu = su[i + GS];
        const float rv = sv[i + 1], bv = sv[i + GS];
        const float p11 = sp[i], p12 = sp[PLANE + i];
        const float p21 = sp[2 * PLANE + i], p22 = sp[3 * PLANE + i];
        const float ux = x_last ? 0.0f : ru - un;
        const float uy = y_last ? 0.0f : bu - un;
        const float vx = x_last ? 0.0f : rv - vn;
        const float vy = y_last ? 0.0f : bv - vn;
        const float inv_u = 1.0f / (1.0f + taut * sqrtf(ux * ux + uy * uy));
        const float inv_v = 1.0f / (1.0f + taut * sqrtf(vx * vx + vy * vy));
        if (col && r >= r0 && r < r1) {
          sp[i] = (p11 + taut * ux) * inv_u;
          sp[PLANE + i] = (p12 + taut * uy) * inv_u;
          sp[2 * PLANE + i] = (p21 + taut * vx) * inv_v;
          sp[3 * PLANE + i] = (p22 + taut * vy) * inv_v;
        }
      }
    }
    __syncthreads();
  }

  if (tx >= halo && tx < halo + tw_) {
#pragma unroll
    for (int k = 0; k < GPPT; ++k) {
      const int r = ty + GROWS * k, i = r * GS + tx;
      if (r < halo || r >= halo + th_) continue;
      const size_t o = (size_t)(oy + r) * W + gx;
#pragma unroll
      for (int q = 0; q < 6; ++q) sout_g[q * hw + o] = sm[q * PLANE + i];
    }
  }

  if (my_partial != nullptr) {   // uniform
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) e += __shfl_xor_sync(0xffffffffu, e, d);
    if ((tid & 31) == 0) red[tid >> 5] = e;
    __syncthreads();
    if (tid == 0) {
      float t = 0.0f;
      for (int w = 0; w < GNW; ++w) t += red[w];
      *my_partial = t;
    }
  }
}

// The test of image b, by its last block, on the partials every block of
// the image has written (read past L1).  A band that ran (act) takes the
// sum of its blocks' partials as its error, the others keep theirs; the
// image has converged when the bands' errors sum to less than eps2 a pixel;
// a band runs next round unless the image has converged or, with
// `adaptive`, it and both its neighbours are under eps2 a pixel on their
// own.  serr: n_bands + 1 floats of shared memory.
__device__ __noinline__ void band_test(const float* partial, const int* act,
                                       float* err_band, int* act_next, int b,
                                       int n_bands, int n_part, int band,
                                       int H, int W, float n_px, float eps2,
                                       int adaptive, float* serr) {
  const int tid = threadIdx.x, lane = tid & 31;
  for (int j = tid >> 5; j < n_bands; j += GNW) {   // a warp per band
    const int o = b * n_bands + j;
    float v;
    if (act[o]) {
      // Four loads in flight at a time, added in the order q = lane,
      // lane + 32, ...
      const float* row = partial + (size_t)o * n_part;
      v = 0.0f;
      int q = lane;
      for (; q + 96 < n_part; q += 128) {
        const float a = __ldcg(row + q), c = __ldcg(row + q + 32);
        const float d = __ldcg(row + q + 64), f = __ldcg(row + q + 96);
        v += a;
        v += c;
        v += d;
        v += f;
      }
      for (; q < n_part; q += 32) v += __ldcg(row + q);
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
      if (lane == 0) err_band[o] = v;
    } else {
      v = err_band[o];
    }
    if (lane == 0) serr[j] = v;
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.0f;
    for (int j = 0; j < n_bands; ++j) s += serr[j];
    serr[n_bands] = s / n_px < eps2 ? 1.0f : 0.0f;
  }
  __syncthreads();
  const bool converged = serr[n_bands] != 0.0f;
  for (int j = tid; j < n_bands; j += GNT) {
    bool run = !converged;
    if (run && adaptive) {
      run = false;
      for (int q = max(j - 1, 0); q <= min(j + 1, n_bands - 1); ++q) {
        const float px = (float)(min(band, H - band * q) * W);
        run = run || serr[q] >= eps2 * px;
      }
    }
    act_next[b * n_bands + j] = run ? 1 : 0;
  }
}

// TEST: the launch ends with the round's test (the round's last launch).
// The others keep the iterations' code as it is without it: the call costs
// the test's instantiation a 4-byte spill (PERF.md).
template <bool TEST>
__global__ void __launch_bounds__(GNT, 2)
pd_chunk_kernel(const float* __restrict__ prep,
                const float* __restrict__ state_in,
                float* __restrict__ state_out, const int* __restrict__ act,
                const int* __restrict__ prev_act, float* __restrict__ partial,
                BandTest test, ChunkGeom g, float l_t, float theta,
                float taut) {
  extern __shared__ float sm[];
  pd_chunk_tile(prep, state_in, state_out, act, prev_act, partial, g, l_t,
                theta, taut, sm);
  if constexpr (TEST) {
    // Every block of the image arrives, whatever path it took, once thread
    // 0 has written its partial.
    __shared__ int last;
    const int b = blockIdx.z;
    if (threadIdx.x == 0)
      last = va::arrive(test.count + b) == (int)(gridDim.x * gridDim.y) - 1;
    __syncthreads();   // also: the state planes are free for the test's sums
    if (!last) return;
    band_test(partial, act, test.err_band, test.act_next, b, g.n_bands,
              g.tiles_band * gridDim.x, g.band, g.H, g.W, test.n_px, test.eps2,
              test.adaptive, sm);
    if (threadIdx.x == 0) test.count[b] = 0;
  }
}

}  // namespace

// prep: (B, 4, H, W) I1wx, I1wy, grad, rho_c; state_in/state_out:
// (B, 6, H, W) u, v, p11, p12, p21, p22, distinct buffers; act:
// (B, cdiv(H, band)) int32, one flag per gating band; prev_act: null, or the
// flags of the launch before, whose state_out was this launch's state_in
// and whose state_in this launch's state_out; partial: null, or
// (B, n_bands * cdiv(band, T), cdiv(W, T)), one error sum per block (0 from
// a frozen block).  halo >= iters + median_k / 2; T + 2 * halo <= 64;
// median_k in {0, 3, 5}.
// count: null, or the round's test in this launch (partial given): count
// (B,) int32, zero, and left zero; err_band (B, n_bands) float32, updated in
// place for the bands that ran; act_next (B, n_bands) int32, the next
// round's flags, a buffer other than act and prev_act.
VA_EXPORT int va_pd_chunk(const float* prep, const float* state_in,
                          float* state_out, const int* act,
                          const int* prev_act, float* partial, int* count,
                          float* err_band, int* act_next, int B, int H,
                          int W, int band, int T, int halo, int iters,
                          int median_k, float l_t, float theta, float taut,
                          float eps2, int adaptive, void* stream) {
  if (iters < 1 || T < 1 || band < 1 ||
      (median_k != 0 && median_k != 3 && median_k != 5) ||
      halo < iters + median_k / 2 || T + 2 * halo > GS)
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
  BandTest test;
  test.count = count;
  test.err_band = err_band;
  test.act_next = act_next;
  test.n_px = (float)((double)H * W);
  test.eps2 = eps2;
  test.adaptive = adaptive;
  if (count != nullptr &&
      (partial == nullptr || err_band == nullptr || act_next == nullptr ||
       g.n_bands + 1 > N_SMEM_PLANES * PLANE))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = (N_SMEM_PLANES * PLANE + GNW) * (int)sizeof(float);
  const bool with_test = count != nullptr;
  const auto kernel =
      with_test ? pd_chunk_kernel<true> : pd_chunk_kernel<false>;
  // Above 48 KB a kernel must opt in to its dynamic shared memory.
  static bool opted_in[2] = {false, false};
  if (!opted_in[with_test]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it: the next launch must not see it
      return (int)err;
    }
    opted_in[with_test] = true;
  }
  const dim3 grid(va::cdiv(W, T), g.n_bands * g.tiles_band, B);
  kernel<<<grid, GNT, smem, (cudaStream_t)stream>>>(
      prep, state_in, state_out, act, prev_act, partial, test, g, l_t, theta,
      taut);
  return (int)cudaGetLastError();
}
