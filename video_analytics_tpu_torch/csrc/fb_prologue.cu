// K-D fb_prologue: one Farneback pyramid level's per-frame work: pre-blur at
// full resolution, bilinear resize to the level, and the polynomial
// expansion, in one launch where a tile's source span fits shared memory,
// else in two (fb_blur_sample_kernel writes the blurred frame at the source
// pixels the level reads, then the expansion kernel reads them).
//
// Replaces video_analytics_tpu/ops/pallas/farneback_kernels.py:
// poly_prologue_pallas (_poly_prologue_kernel) and its unfused twin
// poly_expansion_pallas.
//
// What it computes, per frame n and level pixel (y, x):
//   S      = the frame correlated with the blur taps along y, then along x,
//            reflect-101 border                    (flow/farneback.py
//            _smooth_and_resize; taps from _smooth_taps, any odd number);
//   I      = S resized to (lh, lw): rows first, then columns, each output
//            the sum of its two linear taps (ops/kernels._two_tap); an axis
//            whose size does not change is not resampled;
//   v_k    = I correlated along y with k in (g, xg, xxg), replicate border;
//   s1, sx, sxx = v_g  along x with g, xg, xxg;   sy, sxy = v_xg with g, xg;
//   syy    = v_xxg along x with g;
//   out    = (sx*ig11, sy*ig11, s1*ig03 + sxx*ig33, s1*ig03 + syy*ig33,
//             sxy*ig55)                             (poly_expansion)
// with every sum taken tap by tap in the taps' order, so that it rounds as
// the plain version does.  The horizontal blur ends before the row resize,
// as in the plain version (resizing first would round differently).  A
// resize output with one nonzero tap has its other tap's index set to the
// first one's by the wrapper: its term is S * 0 = +0 either way, frames
// being gray levels >= 0.
//
// The TPU kernel halves x first and only takes levels that are exact 2^k
// divisors of the frame; this one follows the resize tables it is given,
// rows first, at any level size, and its taps are read from device memory
// into shared memory: no count is compiled in.
//
// Design.  A block makes a 32x32 tile of level outputs of one frame (256
// threads, four rows a thread).  The tile and its halo of p = poly_n level
// pixels need S only at 2 source rows per level row and 2 source columns per
// level column ("slots"; 1 on an axis that is not resized).
//   1. Fused (one launch): the vertical blur V at the slot rows, over the
//      source columns the slot columns reach (their span +- the blur radius),
//      goes to shared memory once, each value from its column's n taps; then
//      the horizontal blur S at the slot rows and columns from V, n taps each.
//      The span grows as 1/scale: at 1/8 of a 1080p frame (19 taps) a tile's
//      V takes 84 rows x 355 columns, 119 KB.  Where the widest tile's
//      buffers pass a block's 227 KB (1/16 of 1080p and below), the wrapper
//      takes the second form.
//   2. Two launches: fb_blur_sample_kernel makes S at every slot row and
//      column of the level, a row of a frame a block: V of the whole source
//      row in shared memory (W floats, so frames up to ~58,000 columns),
//      then S at the slot columns, written as an (N, ry*lh, rx*lw)
//      intermediate; the expansion kernel reads its tile's slots from it.
//   3. The resize of the tile and halo from the slots, into shared memory.
//   4. The expansion: three vertical sums of the level tile to shared memory
//      once, six horizontal sums from them, and the combine.  A thread makes
//      four outputs of a pass from the n + 3 values they read (vertical: a
//      column's four rows; horizontal: four of a row, read as 16-byte
//      words), the expansion's taps in registers (its 11 or 15 taps are
//      compile-time counts).  Per output that is the 6 + 3 sums' 198 float
//      operations (no FMA contraction) and ~25 shared-memory reads.
// At 224^2 (scale 1, 3 taps) a block blurs 42 x 44 pixels and expands
// 42 x 42 for 1,024 outputs; the 32x8 tiles of the first design computed
// 2.95 level pixels an output, each from 4 n^2-tap blurred samples.
//
// Bound on the H100: memory.  Each frame pixel is read once (4 B) and each
// level pixel written as 5 planes (20 B); at the finest level of 16 frames
// of 224^2 that is 19 MB, ~6 us at 3.35 TB/s, against ~80 flops per level
// pixel (~0.3 us at 67 TFLOP/s).

#include "common.cuh"

namespace {

constexpr int TW = 32;                // level tile width
constexpr int TH = 32;                // level tile height
constexpr int PNT = 256;              // threads a block
constexpr int RUN = 4;                // outputs a thread makes at a time
static_assert(TW * TH == RUN * PNT, "one run along x per thread");
constexpr int MAX_SMEM = 232448;      // bytes a block may opt in to

struct Prologue {
  int H, W, lh, lw;
  int nb;                // blur taps
  int np;                // expansion taps, 2 * poly_n + 1
  const float* taps;     // nb blur taps, then g, xg, xxg (np each)
  const int* yidx;       // (2, lh) source row of each level row's two taps,
  const float* ywt;      //   and their weights; null: rows not resized
  const int* xidx;       // (2, lw) likewise for the columns
  const float* xwt;
  float ig11, ig03, ig33, ig55;
  int span;              // row length of V (fused form)
};

__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) return -i;
  if (i >= n) return 2 * n - 2 - i;
  return i;
}

// Row length of the vertical sums: a multiple of four floats, so that a
// run's 16-byte reads are aligned.
__host__ __device__ constexpr int vs_stride(int np) {
  return (TW + np - 1 + 3) & ~3;
}

// Floats of shared memory beside the fused form's V: the vertical sums,
// the level tile, S at the slots, the taps and the slots' source indices.
__host__ __device__ inline int tile_floats(int nb, int np, int ry, int rx) {
  const int lh = TH + np - 1, lw = TW + np - 1;
  const int sr = lh * ry, sc = lw * rx;
  return 3 * TH * vs_stride(np) + lh * lw + sr * sc + nb + 3 * np + sr + sc;
}

// RUN correlation sums out[j] = k[0]*v[j] + k[1]*v[j + 1] + ..., each taken
// tap by tap in that order.
template <int NP>
__device__ __forceinline__ void corr_run(const float* v, const float* k,
                                         float out[RUN]) {
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    float a = k[0] * v[j];
#pragma unroll
    for (int t = 1; t < NP; ++t) a = a + k[t] * v[j + t];
    out[j] = a;
  }
}

// FUSED: S at the tile's slots is made from the frames; else read from snd.
// NP: the expansion's taps (11 or 15).
template <bool FUSED, int NP>
__global__ void __launch_bounds__(PNT)
fb_prologue_kernel(const float* __restrict__ frames,
                   const float* __restrict__ snd, float* __restrict__ out,
                   Prologue a) {
  extern __shared__ float4 sm4[];
  constexpr int P = NP / 2;
  constexpr int LH = TH + 2 * P, LW = TW + 2 * P, VSS = vs_stride(NP);
  const int rb = a.nb / 2;
  const int ry = a.yidx ? 2 : 1, rx = a.xidx ? 2 : 1;
  const int SR = LH * ry, SC = LW * rx;
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int n = blockIdx.z;

  float* vs = reinterpret_cast<float*>(sm4);        // 3 x TH x VSS
  float* L = vs + 3 * TH * VSS;                     // LH x LW
  float* Ss = L + LH * LW;                          // SR x SC
  float* tk = Ss + SR * SC;                         // nb + 3 NP taps
  int* rsrc = reinterpret_cast<int*>(tk + a.nb + 3 * NP);   // SR
  int* csrc = rsrc + SR;                            // SC
  float* V = reinterpret_cast<float*>(csrc + SC);   // SR x span (fused)
  const float* kb = tk;

  for (int i = tid; i < a.nb + 3 * NP; i += PNT) tk[i] = a.taps[i];
  // Slot s of the rows: level row gy (clamped: replicate border of the
  // expansion), resize tap s % ry.  FUSED: its source row; else its row of
  // the intermediate, tap-major as the resize tables are.
  for (int s = tid; s < SR; s += PNT) {
    const int gy = min(max(y0 - P + s / ry, 0), a.lh - 1);
    const int t = s % ry;
    rsrc[s] = FUSED ? (ry == 2 ? a.yidx[t * a.lh + gy] : gy) : t * a.lh + gy;
  }
  for (int s = tid; s < SC; s += PNT) {
    const int gx = min(max(x0 - P + s / rx, 0), a.lw - 1);
    const int t = s % rx;
    csrc[s] = FUSED ? (rx == 2 ? a.xidx[t * a.lw + gx] : gx) : t * a.lw + gx;
  }
  __syncthreads();

  if constexpr (FUSED) {
    // The source columns the slots reach, the blur's reach included: the
    // resize tables are monotone, so the first slot and the last.
    const int c_lo = max(0, csrc[0] - rb);
    const int nc = min(a.W - 1, csrc[SC - 1] + rb) - c_lo + 1;
    const float* img = frames + (size_t)n * a.H * a.W + c_lo;
    // 1a. V at the slot rows over those columns.
    for (int i = tid; i < SR * nc; i += PNT) {
      const int s = i / nc, c = i - s * nc;
      const int q = rsrc[s];
      const float* col = img + c;
      float acc = kb[0] * col[(size_t)reflect101(q - rb, a.H) * a.W];
      for (int j = 1; j < a.nb; ++j)
        acc = acc + kb[j] * col[(size_t)reflect101(q + j - rb, a.H) * a.W];
      V[s * a.span + c] = acc;
    }
    __syncthreads();
    // 1b. S at the slot rows and columns.
    for (int i = tid; i < SR * SC; i += PNT) {
      const int s = i / SC, t = i - s * SC;
      const float* v = V + s * a.span - c_lo;
      const int c = csrc[t];
      float acc = kb[0] * v[reflect101(c - rb, a.W)];
      for (int j = 1; j < a.nb; ++j)
        acc = acc + kb[j] * v[reflect101(c + j - rb, a.W)];
      Ss[i] = acc;
    }
  } else {
    // 2. The tile's slots of the intermediate.
    const int rn = ry * a.lh, cn = rx * a.lw;
    const float* sn = snd + (size_t)n * rn * cn;
    for (int i = tid; i < SR * SC; i += PNT) {
      const int s = i / SC, t = i - s * SC;
      Ss[i] = sn[(size_t)rsrc[s] * cn + csrc[t]];
    }
  }
  __syncthreads();

  // 3. The level tile and its halo: rows resized first, then columns.
  for (int i = tid; i < LH * LW; i += PNT) {
    const int r = i / LW, c = i - r * LW;
    const int gy = min(max(y0 - P + r, 0), a.lh - 1);
    const int gx = min(max(x0 - P + c, 0), a.lw - 1);
    float col[2];
    for (int t = 0; t < rx; ++t) {
      const float* s0 = Ss + (r * ry) * SC + c * rx + t;
      col[t] = ry == 2 ? s0[0] * a.ywt[gy] + s0[SC] * a.ywt[a.lh + gy]
                       : s0[0];
    }
    L[i] = rx == 2 ? col[0] * a.xwt[gx] + col[1] * a.xwt[a.lw + gx] : col[0];
  }
  __syncthreads();

  // The expansion's taps, in registers.
  float kg[NP], kxg[NP], kxxg[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    kg[k] = tk[a.nb + k];
    kxg[k] = tk[a.nb + NP + k];
    kxxg[k] = tk[a.nb + 2 * NP + k];
  }

  // 4a. Vertical sums with g, xg, xxg for the tile's rows, halo columns
  // included: rows 4g .. 4g + 3 of one column an item.
  for (int i = tid; i < (TH / RUN) * LW; i += PNT) {
    const int g = i / LW, b = i - g * LW;
    const float* src = L + g * RUN * LW + b;
    float v[NP + RUN - 1];
#pragma unroll
    for (int k = 0; k < NP + RUN - 1; ++k) v[k] = src[k * LW];
    float o[RUN];
    float* dst = vs + g * RUN * VSS + b;
    corr_run<NP>(v, kg, o);
#pragma unroll
    for (int j = 0; j < RUN; ++j) dst[j * VSS] = o[j];
    corr_run<NP>(v, kxg, o);
#pragma unroll
    for (int j = 0; j < RUN; ++j) dst[TH * VSS + j * VSS] = o[j];
    corr_run<NP>(v, kxxg, o);
#pragma unroll
    for (int j = 0; j < RUN; ++j) dst[2 * TH * VSS + j * VSS] = o[j];
  }
  __syncthreads();

  // 4b. The six horizontal sums of the thread's run of four outputs of one
  // row, a plane of vertical sums at a time, then the combine.
  const int r = tid / (TW / RUN), xg = tid - r * (TW / RUN);
  constexpr int NV = (NP + RUN - 1 + 3) / 4;        // 16-byte words
  float s1[RUN], sx[RUN], sxx[RUN], sy[RUN], sxy[RUN], syy[RUN];
  {
    float4 v4[NV];
    const float4* src =
        reinterpret_cast<const float4*>(vs + r * VSS + xg * RUN);
#pragma unroll
    for (int i = 0; i < NV; ++i) v4[i] = src[i];
    const float* v = reinterpret_cast<const float*>(v4);
    corr_run<NP>(v, kg, s1);
    corr_run<NP>(v, kxg, sx);
    corr_run<NP>(v, kxxg, sxx);
  }
  {
    float4 v4[NV];
    const float4* src =
        reinterpret_cast<const float4*>(vs + (TH + r) * VSS + xg * RUN);
#pragma unroll
    for (int i = 0; i < NV; ++i) v4[i] = src[i];
    const float* v = reinterpret_cast<const float*>(v4);
    corr_run<NP>(v, kg, sy);
    corr_run<NP>(v, kxg, sxy);
  }
  {
    float4 v4[NV];
    const float4* src =
        reinterpret_cast<const float4*>(vs + (2 * TH + r) * VSS + xg * RUN);
#pragma unroll
    for (int i = 0; i < NV; ++i) v4[i] = src[i];
    corr_run<NP>(reinterpret_cast<const float*>(v4), kg, syy);
  }
  const int y = y0 + r;
  const size_t hw = (size_t)a.lh * a.lw;
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    const int x = x0 + xg * RUN + j;
    if (x >= a.lw || y >= a.lh) continue;
    float* o = out + (size_t)n * 5 * hw + (size_t)y * a.lw + x;
    o[0] = sx[j] * a.ig11;
    o[hw] = sy[j] * a.ig11;
    o[2 * hw] = s1[j] * a.ig03 + sxx[j] * a.ig33;
    o[3 * hw] = s1[j] * a.ig03 + syy[j] * a.ig33;
    o[4 * hw] = sxy[j] * a.ig55;
  }
}

// The blurred frame at every slot column of one slot row of a level: row
// blockIdx.x of the intermediate of frame blockIdx.y.
__global__ void __launch_bounds__(PNT)
fb_blur_sample_kernel(const float* __restrict__ frames,
                      float* __restrict__ snd, Prologue a) {
  extern __shared__ float sm[];
  const int rb = a.nb / 2;
  const int rn = (a.yidx ? 2 : 1) * a.lh, cn = (a.xidx ? 2 : 1) * a.lw;
  const int r = blockIdx.x, n = blockIdx.y;
  const int tid = threadIdx.x;
  float* kb = sm;
  float* V = sm + a.nb;                 // W floats
  for (int i = tid; i < a.nb; i += PNT) kb[i] = a.taps[i];
  __syncthreads();
  const int q = a.yidx ? a.yidx[r] : r;
  const float* img = frames + (size_t)n * a.H * a.W;
  for (int c = tid; c < a.W; c += PNT) {
    const float* col = img + c;
    float acc = kb[0] * col[(size_t)reflect101(q - rb, a.H) * a.W];
    for (int j = 1; j < a.nb; ++j)
      acc = acc + kb[j] * col[(size_t)reflect101(q + j - rb, a.H) * a.W];
    V[c] = acc;
  }
  __syncthreads();
  float* dst = snd + ((size_t)n * rn + r) * cn;
  for (int t = tid; t < cn; t += PNT) {
    const int c = a.xidx ? a.xidx[t] : t;
    float acc = kb[0] * V[reflect101(c - rb, a.W)];
    for (int j = 1; j < a.nb; ++j)
      acc = acc + kb[j] * V[reflect101(c + j - rb, a.W)];
    dst[t] = acc;
  }
}

int set_smem(const void* kernel, int smem, int* smem_set) {
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > *smem_set) {               // above 48 KB a kernel must opt in
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
    *smem_set = smem;
  }
  return 0;
}

// One launch of the expansion kernel, fused or reading snd.
template <int NP>
int expand(const float* frames, const float* snd, float* out,
           const Prologue& a, int N, int smem, cudaStream_t s) {
  static int smem_set[2] = {0, 0};      // what each form has opted in to
  const dim3 grid(va::cdiv(a.lw, TW), va::cdiv(a.lh, TH), N);
  int err;
  if (snd == nullptr) {
    if ((err = set_smem((const void*)fb_prologue_kernel<true, NP>, smem,
                        &smem_set[0])))
      return err;
    fb_prologue_kernel<true, NP><<<grid, PNT, smem, s>>>(frames, nullptr, out,
                                                         a);
  } else {
    if ((err = set_smem((const void*)fb_prologue_kernel<false, NP>, smem,
                        &smem_set[1])))
      return err;
    fb_prologue_kernel<false, NP><<<grid, PNT, smem, s>>>(frames, snd, out,
                                                          a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of shared memory a block of the fused form needs, with V rows of
// `span` floats, or -1 above the 232,448 a block may have; the wrapper takes
// the fused form where it fits.  yres, xres: whether rows, columns are
// resized.
VA_EXPORT int va_fb_prologue_smem(int n_blur, int n_poly, int yres, int xres,
                                  int span) {
  const int ry = yres ? 2 : 1;
  const long long sr = (long long)(TH + n_poly - 1) * ry;
  const long long bytes =
      4LL * (tile_floats(n_blur, n_poly, ry, xres ? 2 : 1) + sr * span);
  return bytes > MAX_SMEM ? -1 : (int)bytes;
}

// frames: (N, H, W); out: (N, 5, lh, lw).  taps: device, n_blur blur taps
// (odd, radius below H and W), then g, xg, xxg of n_poly taps each (11 or
// 15: poly_n 5 or 7).  yidx/ywt: device (2, lh) resize taps along y, or null
// when lh == H and the axis is not resampled; xidx/xwt likewise, (2, lw).
// snd: null for the fused form with V rows of `span` floats; else an
// (N, ry*lh, rx*lw) scratch (ry = 2 where the rows are resized, else 1; rx
// likewise) that a first launch fills (span is then ignored).
VA_EXPORT int va_fb_prologue(const float* frames, float* out, float* snd,
                             int N, int H, int W, int lh, int lw,
                             const float* taps, int n_blur, int n_poly,
                             const int* yidx, const float* ywt,
                             const int* xidx, const float* xwt, float ig11,
                             float ig03, float ig33, float ig55, int span,
                             void* stream) {
  static int smem_blur = 0;
  if (n_blur % 2 != 1 || (n_poly != 11 && n_poly != 15) || n_blur / 2 >= H ||
      n_blur / 2 >= W || N < 1 || lh < 1 || lw < 1)
    return (int)cudaErrorInvalidValue;
  Prologue a;
  a.H = H;
  a.W = W;
  a.lh = lh;
  a.lw = lw;
  a.nb = n_blur;
  a.np = n_poly;
  a.taps = taps;
  a.yidx = yidx;
  a.ywt = ywt;
  a.xidx = xidx;
  a.xwt = xwt;
  a.ig11 = ig11;
  a.ig03 = ig03;
  a.ig33 = ig33;
  a.ig55 = ig55;
  a.span = span;
  const cudaStream_t s = (cudaStream_t)stream;
  const int ry = yidx ? 2 : 1, rx = xidx ? 2 : 1;
  int smem = 4 * tile_floats(n_blur, n_poly, ry, rx);
  int err = 0;
  if (snd == nullptr) {
    smem = va_fb_prologue_smem(n_blur, n_poly, yidx != nullptr,
                               xidx != nullptr, span);
    if (smem < 0) return (int)cudaErrorInvalidValue;
  } else {
    const int blur_smem = 4 * (n_blur + W);
    if ((err = set_smem((const void*)fb_blur_sample_kernel, blur_smem,
                        &smem_blur)))
      return err;
    fb_blur_sample_kernel<<<dim3(ry * lh, N), PNT, blur_smem, s>>>(frames,
                                                                   snd, a);
    if ((err = (int)cudaGetLastError())) return err;
  }
  return n_poly == 11 ? expand<11>(frames, snd, out, a, N, smem, s)
                      : expand<15>(frames, snd, out, a, N, smem, s);
}
