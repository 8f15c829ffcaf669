// K-D fb_prologue: one Farneback pyramid level's per-frame work in one
// launch: pre-blur at full resolution, bilinear resize to the level, and
// the polynomial expansion.
//
// Replaces video_analytics_tpu/ops/pallas/farneback_kernels.py:
// poly_prologue_pallas (_poly_prologue_kernel) and its unfused twin
// poly_expansion_pallas.
//
// What it computes, per frame n and level pixel (y, x):
//   S      = the frame correlated with the blur taps along y, then along x,
//            reflect-101 border                    (flow/farneback.py
//            _smooth_and_resize; taps from _smooth_taps);
//   I      = S resized to (lh, lw): rows first, then columns, each output
//            the sum of its two nonzero linear taps (ops/kernels._two_tap);
//            an axis whose size does not change is not resampled;
//   v_k    = I correlated along y with k in (g, xg, xxg), replicate border;
//   s1, sx, sxx = v_g  along x with g, xg, xxg;   sy, sxy = v_xg with g, xg;
//   syy    = v_xxg along x with g;
//   out    = (sx*ig11, sy*ig11, s1*ig03 + sxx*ig33, s1*ig03 + syy*ig33,
//             sxy*ig55)                             (poly_expansion)
// with every sum taken tap by tap in the taps' order, so that it rounds as
// the plain version does.
//
// The TPU kernel halves x first and only takes levels that are exact 2^k
// divisors of the frame; this one follows the resize tables it is given,
// rows first, at any level size.
//
// Design.  A block makes a 32x8 tile of outputs.  It first fills the tile
// and its halo of poly_n pixels with level pixels I in shared memory: each
// is computed from the frame directly, 4 blurred samples of (2r+1)^2 taps,
// read through L1.  That repeats blur work between neighbours (the blurred
// frame and the level image are never written to device memory, and the
// taps per level pixel fall as the level shrinks, so the total stays near
// 25-80 multiply-adds per frame pixel at every scale).  Then the three
// vertical sums go to shared memory once and the six horizontal sums read
// them: three vertical sums shared by six horizontal ones.
//
// Bound on the H100: memory.  Each frame pixel is read once (4 B) and each
// level pixel written as 5 planes (20 B); at the finest level of 16 frames
// of 224^2 that is 19 MB, ~6 us at 3.35 TB/s, against ~220 flops per level
// pixel (~3 us at 67 TFLOP/s).  The kernel as written is bound by its own
// redundant blur arithmetic and shared-memory passes instead; tiling the
// blur through shared memory is the next step.

#include "common.cuh"

namespace {

constexpr int MAX_R = va::MAX_TAPS / 2;
constexpr int TILE_W = va::TX + 2 * MAX_R;
constexpr int TILE_H = va::TY + 2 * MAX_R;

struct Expansion {
  va::Taps g, xg, xxg;
  float ig11, ig03, ig33, ig55;
};

// Resize tables of one axis: idx and wt are (2, n_out); null = no resize.
struct Axis {
  const int* idx;
  const float* wt;
  int n_out;
};

__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) return -i;
  if (i >= n) return 2 * n - 2 - i;
  return i;
}

// The blur taps: the block's copy in shared memory.
struct Blur {
  const float* k;
  int n;
};

// The blurred frame at (y, x): vertical pass, then horizontal.
__device__ float blurred(const float* __restrict__ img, int H, int W, int y,
                         int x, Blur b) {
  const int r = b.n / 2;
  float acc = 0.0f;
  for (int j = 0; j < b.n; ++j) {
    const int xx = reflect101(x + j - r, W);
    float v = 0.0f;
    for (int i = 0; i < b.n; ++i) {
      const float term = b.k[i] * img[reflect101(y + i - r, H) * W + xx];
      v = i == 0 ? term : v + term;
    }
    const float term = b.k[j] * v;
    acc = j == 0 ? term : acc + term;
  }
  return acc;
}

// The blurred frame resized along y only, at level row y, frame column x.
__device__ float level_column(const float* __restrict__ img, int H, int W,
                              int y, int x, Blur b, Axis ay) {
  if (ay.idx == nullptr) return blurred(img, H, W, y, x, b);
  const float a = blurred(img, H, W, ay.idx[y], x, b) * ay.wt[y];
  const float c =
      blurred(img, H, W, ay.idx[ay.n_out + y], x, b) * ay.wt[ay.n_out + y];
  return a + c;
}

__device__ float level_pixel(const float* __restrict__ img, int H, int W,
                             int y, int x, Blur b, Axis ay, Axis ax) {
  if (ax.idx == nullptr) return level_column(img, H, W, y, x, b, ay);
  const float a = level_column(img, H, W, y, ax.idx[x], b, ay) * ax.wt[x];
  const float c = level_column(img, H, W, y, ax.idx[ax.n_out + x], b, ay) *
                  ax.wt[ax.n_out + x];
  return a + c;
}

__global__ void __launch_bounds__(va::NT)
fb_prologue_kernel(const float* __restrict__ frames, float* __restrict__ out,
                   int H, int W, int lh, int lw, va::Taps blur, Axis ay,
                   Axis ax, Expansion e) {
  __shared__ float tile[TILE_H * TILE_W];
  __shared__ float vsum[3][va::TY * TILE_W];
  __shared__ float bk[va::MAX_TAPS];          // blur taps
  __shared__ float ek[3][va::MAX_TAPS];       // g, xg, xxg

  const int n = e.g.n;
  const int r = n / 2;
  const int tw = va::TX + 2 * r;
  const int th = va::TY + 2 * r;
  const int tid = threadIdx.y * va::TX + threadIdx.x;
  const int x0 = blockIdx.x * va::TX;
  const int y0 = blockIdx.y * va::TY;
  const float* img = frames + (size_t)blockIdx.z * H * W;
  if (tid < va::MAX_TAPS) {
    bk[tid] = blur.k[tid];
    ek[0][tid] = e.g.k[tid];
    ek[1][tid] = e.xg.k[tid];
    ek[2][tid] = e.xxg.k[tid];
  }
  __syncthreads();
  const Blur b = {bk, blur.n};

  // Level pixels of the tile and its halo; replicate border of the
  // expansion = clamped level coordinates.
  for (int i = tid; i < th * tw; i += va::NT) {
    const int gy = min(max(y0 + i / tw - r, 0), lh - 1);
    const int gx = min(max(x0 + i % tw - r, 0), lw - 1);
    tile[i] = level_pixel(img, H, W, gy, gx, b, ay, ax);
  }
  __syncthreads();

  // Vertical sums with g, xg, xxg for the tile's rows, halo columns
  // included.
  for (int i = tid; i < va::TY * tw; i += va::NT) {
    const float* col = tile + (i / tw) * tw + i % tw;
    float sg = 0.0f, sxg = 0.0f, sxxg = 0.0f;
    for (int k = 0; k < n; ++k) {
      const float p = col[k * tw];
      const float tg = ek[0][k] * p;
      const float txg = ek[1][k] * p;
      const float txxg = ek[2][k] * p;
      sg = k == 0 ? tg : sg + tg;
      sxg = k == 0 ? txg : sxg + txg;
      sxxg = k == 0 ? txxg : sxxg + txxg;
    }
    vsum[0][i] = sg;
    vsum[1][i] = sxg;
    vsum[2][i] = sxxg;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= lw || y >= lh) return;
  const int base = threadIdx.y * tw + threadIdx.x;
  float s1 = 0.0f, sx = 0.0f, sy = 0.0f, sxx = 0.0f, syy = 0.0f, sxy = 0.0f;
  for (int k = 0; k < n; ++k) {
    const float vg = vsum[0][base + k];
    const float vxg = vsum[1][base + k];
    const float vxxg = vsum[2][base + k];
    const float t1 = ek[0][k] * vg;
    const float tx = ek[1][k] * vg;
    const float ty = ek[0][k] * vxg;
    const float txx = ek[2][k] * vg;
    const float tyy = ek[0][k] * vxxg;
    const float txy = ek[1][k] * vxg;
    s1 = k == 0 ? t1 : s1 + t1;
    sx = k == 0 ? tx : sx + tx;
    sy = k == 0 ? ty : sy + ty;
    sxx = k == 0 ? txx : sxx + txx;
    syy = k == 0 ? tyy : syy + tyy;
    sxy = k == 0 ? txy : sxy + txy;
  }
  const size_t hw = (size_t)lh * lw;
  float* o = out + (size_t)blockIdx.z * 5 * hw + (size_t)y * lw + x;
  o[0] = sx * e.ig11;
  o[hw] = sy * e.ig11;
  o[2 * hw] = s1 * e.ig03 + sxx * e.ig33;
  o[3 * hw] = s1 * e.ig03 + syy * e.ig33;
  o[4 * hw] = sxy * e.ig55;
}

}  // namespace

// frames: (N, H, W); out: (N, 5, lh, lw).  blur: n_blur taps (odd, radius
// below H and W).  yidx/ywt: (2, lh) resize taps along y, or null when
// lh == H and the axis is not resampled; xidx/xwt likewise, (2, lw).
// g, xg, xxg: n_poly taps each (odd); n_blur, n_poly <= va::MAX_TAPS.
VA_EXPORT int va_fb_prologue(const float* frames, float* out, int N, int H,
                             int W, int lh, int lw, const float* blur,
                             int n_blur, const int* yidx, const float* ywt,
                             const int* xidx, const float* xwt,
                             const float* g, const float* xg,
                             const float* xxg, int n_poly, float ig11,
                             float ig03, float ig33, float ig55,
                             void* stream) {
  if (n_blur > va::MAX_TAPS || n_poly > va::MAX_TAPS || n_blur % 2 != 1 ||
      n_poly % 2 != 1)
    return (int)cudaErrorInvalidValue;
  Expansion e;
  e.g = va::make_taps(g, n_poly);
  e.xg = va::make_taps(xg, n_poly);
  e.xxg = va::make_taps(xxg, n_poly);
  e.ig11 = ig11;
  e.ig03 = ig03;
  e.ig33 = ig33;
  e.ig55 = ig55;
  const Axis ay = {yidx, ywt, lh};
  const Axis ax = {xidx, xwt, lw};
  const dim3 block(va::TX, va::TY);
  const dim3 grid(va::cdiv(lw, va::TX), va::cdiv(lh, va::TY), N);
  fb_prologue_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      frames, out, H, W, lh, lw, va::make_taps(blur, n_blur), ay, ax, e);
  return (int)cudaGetLastError();
}
