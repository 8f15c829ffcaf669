// K-H tvl1_scale: every warp of one TV-L1 pyramid scale in one launch, one
// image per thread-block cluster, the solver state resident in (distributed)
// shared memory from the scale's first iteration to its last.
//
// Replaces the solvers of video_analytics_tpu/ops/pallas/tvl1_solve.py
// that keep an image's state on chip: tvl1_solve_warp,
// tvl1_solve_warp_packed and tvl1_scale_pallas (kernel
// _scale_kernel_packed), which runs the warp of (I1, I1x, I1y), the prep,
// the solver of every warp of a scale and the scale-end median in one
// launch.  One entry point, va_pd_scale, runs `warps` warps, each opening
// with warp_prep.cu's arithmetic as the kernel's prologue (the thread
// gathers I1, I1x, I1y at its own pixels moved by the u, v its strip holds,
// through L1/L2: they are read-only for the whole scale, so no strip needs
// to hold them), the dual and the round count reset as a fresh warp resets
// them, and after the last warp the k x k median once more (the scale-end
// median of flow/tvl1.py).  The constants never reach device memory where
// they fit shared memory; where they do not, a block writes its strip's
// three planes to a caller-given scratch and reads them back through L2
// (each thread only what it wrote itself).
// Each warp computes what the per-iteration chain of tvl1_pd.cu + median.cu
// computes from warp_prep.cu's constants
// (ops/cuda/tvl1_solve.pd_solve): up to `outer` rounds, each the k x k
// median of (u, v) (k in {0, 3, 5}, replicate border), `inner` iterations of
//   rho = rho_c + I1wx*u + I1wy*v
//   d   = l_t if rho < -l_t*grad, -l_t if rho > l_t*grad,
//         else -rho / max(grad, 1e-10)
//   un  = u + d*I1wx + theta * div(p11, p12)   (vn likewise with p21, p22)
//   p  <- (p + taut*grad(un)) / (1 + taut*|grad(un)|)
// and the test  mean((un-u)^2 + (vn-v)^2) of the last iteration < eps^2,
// after which the image's state is final for the warp.  The dual starts
// each warp at zero.
//
// Design.  One block has 227 KB of shared memory, a 224^2 image's six state
// planes are 1.2 MB; a cluster of eight blocks has 8 x 227 KB.  So:
//   - grid (CL, B), cluster (CL, 1, 1).  CL is given with each launch
//     (cudaLaunchKernelEx) and may be any of 1, 2, 4, 8 and 16 blocks
//     whose strips fit (16 is Hopper's non-portable maximum, opted in per
//     kernel: 16 SMs of one GPC at one block an SM).  The caller chooses
//     it for the batch (ops/cuda/tvl1_solve.scale_blocks, up to the size
//     of warp_geometry: 8 where the strips fit, else 16): a smaller
//     cluster puts more images on the card at once, so a large batch runs
//     in fewer passes of clusters over the card, each pass paying the
//     latency of an iteration of a strip.  The per-pixel arithmetic is the
//     same at every size.  Block r of an image's cluster owns the strip of
//     RS = ceil(H / CL) rows from r * RS (a late block's strip may be short
//     or empty; it still takes part in every barrier; a strip of a cluster
//     of one is the image).  u, v, p11, p12, p21, p22 of the strip live in
//     its shared memory for the whole scale: u, v are read once and
//     written once however many warps it has;
//   - an iteration is two in-place phases.  Phase A forms (un, vn) from the
//     pixel's own u, v and the dual of the pixel, its left and its upper
//     neighbour; phase B forms the new dual from un of the pixel, its right
//     and its lower neighbour.  Neither writes what the other's neighbours
//     read.  The row above a strip (p12, p22) and the row below it (un, vn)
//     live in halo rows of the strip's own planes, which the neighbouring
//     block fills through distributed shared memory
//     (cluster.map_shared_rank) as it computes them: a remote store is not
//     waited for, a remote load in every iteration would be.  A cluster
//     barrier follows each phase, two an iteration at ~1 us each.  (Split
//     into arrive and wait, with the pixels that read no halo row worked on
//     between the halves after a block barrier, the warp took 1.1 times as
//     long: the second pass over a thread's pixels costs more than the
//     wait.)  The phases are free of branches (edges
//     are selects on loads that are always in bounds), so the compiler
//     interleaves a thread's pixels;
//   - a thread owns the same pixels of the strip throughout (pixel tid +
//     k * 512 of the strip as one flat array, so neighbouring threads read
//     neighbouring words).  The constants never change during a warp.
//     Each thread keeps l_t*grad and 1/max(grad, 1e-10) of its pixels in
//     registers (2 x 13 at 224^2); I1wx, I1wy and rho_c of the strip lie in
//     shared memory beside the state where nine planes fit (up to 224^2
//     in 8 blocks: 229,632 B), and in scratch, read through L2 each
//     iteration, where they do not (256^2).  The kernel is instantiated
//     for 4, 8, 13, 16 and 20 pixels a thread;
//   - the unrolled phases must not let the compiler hoist what is invariant
//     over the iterations (every pixel's addresses and edge predicates): it
//     spills them, 544 B a thread at 13 pixels, and the warp takes 1.5 times
//     as long.  The thread's index and flag words are therefore copied
//     through an opaque move once an iteration (`opaque`);
//   - the median gathers its window from the raw u, v of the strip and of
//     up to two rows of each neighbour (read through distributed shared
//     memory, clamped to the image), writes the result to the strip's rows
//     of the output buffer, and after a cluster barrier each thread reads
//     back what it wrote.  No scratch plane: the dual carries over between
//     rounds;
//   - the test stays inside.  Each block sums its strip's squared update in
//     a fixed order (per thread, a shuffle tree, the warps in turn); every
//     thread then adds the CL block sums in rank order, so the decision
//     is the same in every thread of the cluster and an image leaves the
//     loop on its own round.  No flag in device memory, no atomics, no host
//     read: a run repeats bit for bit and an image's result does not depend
//     on its batch.  A last barrier keeps a block's shared memory alive
//     until its neighbours have read it.
//   - the prologue runs once a warp, a pixel at a time in a scope of its
//     own that ends before the iteration loop (the gather's addresses must
//     not stay live through it), from an opaque copy of the thread index
//     like the phases.  A cluster barrier stands between a warp's last
//     phase and the next prologue's reset of the halo rows.
// The arithmetic and its order are those of warp_prep.cu, tvl1_pd.cu and
// median.cu (no FMA contraction, IEEE division and square root), so the
// state equals the plain versions' to the last bit; only the order of the
// test's sum differs.
//
// Bound on the H100: operations.  A scale reads 6 planes (I1, I1x, I1y, I0,
// u, v) and writes 2 for, a pixel and warp, ~45 float operations of the
// prologue and rounds * (inner * ~70 + 2 * 2 * 113 with the 5x5 median):
// one warp of 15 pairs of 224^2 at 300 iterations is 15.8 GFLOP, 0.24 ms at
// 67 TFLOP/s, against 0.007 ms for the bytes.

#include <cooperative_groups.h>

#include "common.cuh"
#include "median_network.h"

namespace cg = cooperative_groups;

namespace {

constexpr int WNT = 512;              // threads per block
constexpr int WNW = WNT / 32;         // warps per block
constexpr int SCRATCH = 64;           // floats: WNW warp sums, the block's sum,
                                      // the padding before p11 and p21
constexpr int MAX_SMEM = 232448;      // bytes a block may opt in to

// A copy of x the compiler cannot see through.  Taken once an iteration of
// the thread's index and flag words: what is derived from them (a pixel's
// addresses, its edge predicates) is then formed anew each iteration from
// two or three registers, not hoisted out of the loop for every pixel of
// the thread and spilled.
__device__ __forceinline__ int opaque(int x) {
  int y;
  asm volatile("mov.b32 %0, %1;" : "=r"(y) : "r"(x));
  return y;
}
__device__ __forceinline__ unsigned long long opaque(unsigned long long x) {
  unsigned long long y;
  asm volatile("mov.b64 %0, %1;" : "=l"(y) : "l"(x));
  return y;
}

// Per-pixel position flags within the strip.
constexpr unsigned F_LEFT = 1u;       // first column of the image
constexpr unsigned F_RIGHT = 2u;      // last column of the image
constexpr unsigned F_TOP = 4u;        // first row of the strip
constexpr unsigned F_BOT = 8u;        // last row of the strip

struct WarpGeom {
  int H, W;
  int CL;          // blocks per cluster: 1, 2, 4, 8 or 16
  int RS;          // rows per strip: cdiv(H, CL)
  int inner;       // iterations per round
  int outer;       // rounds at most
  int median_k;    // 0, 3 or 5
  int warps;       // warps in this launch
  float l_t, theta, taut;
  float eps2;      // the test's threshold, epsilon squared
  float n_px;      // H * W
};

// What a block knows of its strip.  Pixel i of the strip (row-major, n of
// them) is su[i], sv[i], sp11[i], sp21[i], sp12[W + i], sp22[W + i].
struct Strip {
  float* su;       // n floats, then a halo row: the first row of the strip
  float* sv;       //   below, stored there by the block that owns it
  float* sp11;     // n floats (one float of padding before each)
  float* sp21;
  float* sp12;     // a halo row (the last row of the strip above, stored by
  float* sp22;     //   its owner; zeros in the first strip), then n floats
  const float* cwx;    // I1wx, I1wy, rho_c of the strip: shared memory or
  const float* cwy;    //   scratch
  const float* crho;
  float* up_u;     // the halo rows of u, v of the block above
  float* up_v;
  float* dn_p12;   // the halo rows of p12, p22 of the block below
  float* dn_p22;
  int W;
  int rows;            // rows of this strip
  bool first;          // the strip holds the image's first row
  bool last;           // ... its last row
  float l_t, theta, taut;
};

__device__ __forceinline__ unsigned edge_flags(int i, int W, int rows) {
  const int r = i / W, c = i - r * W;
  return (c == 0 ? F_LEFT : 0u) | (c == W - 1 ? F_RIGHT : 0u) |
         (r == 0 ? F_TOP : 0u) | (r == rows - 1 ? F_BOT : 0u);
}

// Phase A at pixel i of the strip: (u, v) <- (un, vn) in place, and into
// the halo of the block above for the strip's first row.  Every load is in
// bounds whatever the flags; the edges are selects.  Returns the squared
// update if SQ, else 0.
template <bool SQ>
__device__ __forceinline__ float step_a(const Strip& s, int i, unsigned f,
                                        float th, float inv_grad) {
  const float wx = s.cwx[i], wy = s.cwy[i], rho_c = s.crho[i];
  const float uu = s.su[i], vv = s.sv[i];
  const float p11 = s.sp11[i], p21 = s.sp21[i];
  const float l11 = s.sp11[i - 1], l21 = s.sp21[i - 1];
  const float p12 = s.sp12[s.W + i], p22 = s.sp22[s.W + i];
  const float a12 = s.sp12[i], a22 = s.sp22[i];
  const float rho = rho_c + wx * uu + wy * vv;
  const float d =
      rho < -th ? s.l_t : (rho > th ? -s.l_t : -rho * inv_grad);
  const float v1 = uu + d * wx;
  const float v2 = vv + d * wy;
  const float d11 = (f & F_LEFT) ? p11 : p11 - l11;
  const float d21 = (f & F_LEFT) ? p21 : p21 - l21;
  // The first strip's halo row is zero: p - 0 = p, the image's first row.
  const float d12 = p12 - a12;
  const float d22 = p22 - a22;
  const float un = v1 + s.theta * (d11 + d12);
  const float vn = v2 + s.theta * (d21 + d22);
  s.su[i] = un;
  s.sv[i] = vn;
  if ((f & F_TOP) && !s.first) {   // r == 0, so i is the column
    s.up_u[i] = un;
    s.up_v[i] = vn;
  }
  if (!SQ) return 0.0f;
  const float du = un - uu, dv = vn - vv;
  return du * du + dv * dv;
}

// Phase B at pixel i: the dual from the forward gradient of (un, vn), and
// into the halo of the block below for the strip's last row.
__device__ __forceinline__ void step_b(const Strip& s, int i, unsigned f) {
  const float un = s.su[i], vn = s.sv[i];
  const float ru = s.su[i + 1], rv = s.sv[i + 1];
  const float bu = s.su[i + s.W], bv = s.sv[i + s.W];
  const float p11 = s.sp11[i], p21 = s.sp21[i];
  const float p12 = s.sp12[s.W + i], p22 = s.sp22[s.W + i];
  const bool right = f & F_RIGHT;
  const bool bottom = (f & F_BOT) && s.last;   // the image's last row
  const float ux = right ? 0.0f : ru - un;
  const float vx = right ? 0.0f : rv - vn;
  const float uy = bottom ? 0.0f : bu - un;
  const float vy = bottom ? 0.0f : bv - vn;
  const float inv_u = 1.0f / (1.0f + s.taut * sqrtf(ux * ux + uy * uy));
  const float inv_v = 1.0f / (1.0f + s.taut * sqrtf(vx * vx + vy * vy));
  const float n12 = (p12 + s.taut * uy) * inv_u;
  const float n22 = (p22 + s.taut * vy) * inv_v;
  s.sp11[i] = (p11 + s.taut * ux) * inv_u;
  s.sp21[i] = (p21 + s.taut * vx) * inv_v;
  s.sp12[s.W + i] = n12;
  s.sp22[s.W + i] = n22;
  if ((f & F_BOT) && !s.last) {
    const int c = i - (s.rows - 1) * s.W;
    s.dn_p12[c] = n12;
    s.dn_p22[c] = n22;
  }
}

// The K x K median of one plane at row gy, column c of the image, from the
// raw values in the cluster's shared memory (`plane` is this block's copy).
template <int K>
__device__ __forceinline__ float cluster_median(cg::cluster_group& cluster,
                                                float* plane, int gy, int c,
                                                int H, int W, int RS) {
  constexpr int R = K / 2;
  float w[K * K];
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
    const int y = min(max(gy - R + dy, 0), H - 1);
    const int rk = y / RS;
    const float* row = cluster.map_shared_rank(plane, rk) + (y - rk * RS) * W;
#pragma unroll
    for (int dx = 0; dx < K; ++dx)
      w[dy * K + dx] = row[min(max(c - R + dx, 0), W - 1)];
  }
  if constexpr (K == 3) {
    return va_median9(w);
  } else {
    return va_median25(w);
  }
}

// Medians of the strip's u and v, staged in the strip's rows of the output
// buffer (gu, gv point at the strip's first pixel).
template <int K>
__device__ __forceinline__ void median_to_global(cg::cluster_group& cluster,
                                                 const Strip& s, int y0, int n,
                                                 int H, int RS, float* gu,
                                                 float* gv) {
#pragma unroll 1
  for (int i = threadIdx.x; i < n; i += WNT) {
    const int r = i / s.W, c = i - r * s.W;
    gu[i] = cluster_median<K>(cluster, s.su, y0 + r, c, H, s.W, RS);
    gv[i] = cluster_median<K>(cluster, s.sv, y0 + r, c, H, s.W, RS);
  }
}

// A thread owns up to PPT pixels of the strip (n <= PPT * WNT).  SC: I1wx,
// I1wy and rho_c of the strip lie in shared memory; otherwise they are read
// each iteration from scratch.  They come from i13, i0 and the strip's u, v
// at the start of every warp.
template <int PPT, bool SC>
__global__ void __launch_bounds__(WNT, 1)
pd_warp_kernel(const float* __restrict__ i13,
               const float* __restrict__ i0, const float* __restrict__ uv_in,
               float* __restrict__ uv_out, float* scratch,
               int* __restrict__ rounds_out, WarpGeom g) {
  extern __shared__ float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int H = g.H, W = g.W, RS = g.RS;
  const size_t hw = (size_t)H * W;
  const int y0 = min(rank * RS, H);
  const int y1 = min(y0 + RS, H);
  const int n = (y1 - y0) * W;        // pixels of this strip
  const int cap = RS * W;             // floats per plane, in every block

  Strip s;
  s.su = sm;                          // cap + W floats
  s.sv = s.su + cap + W;
  s.sp12 = s.sv + cap + W;            // W + cap floats
  s.sp22 = s.sp12 + W + cap;
  s.sp11 = s.sp22 + W + cap + 1;      // 1 + cap floats each
  s.sp21 = s.sp11 + cap + 1;
  float* red = s.sp21 + cap;          // WNW warp sums
  float* bsum = red + WNW;            // the block's sum
  float* consts = sm + 6 * cap + 4 * W + SCRATCH;   // 3 * cap floats, if SC
  s.W = W;
  s.rows = y1 - y0;
  s.first = y0 == 0;
  s.last = y1 == H;
  s.l_t = g.l_t;
  s.theta = g.theta;
  s.taut = g.taut;
  // A block above a strip that is not empty holds RS rows.
  const int above = max(rank - 1, 0), below = min(rank + 1, g.CL - 1);
  s.up_u = cluster.map_shared_rank(s.su, above) + cap;
  s.up_v = cluster.map_shared_rank(s.sv, above) + cap;
  s.dn_p12 = cluster.map_shared_rank(s.sp12, below);
  s.dn_p22 = cluster.map_shared_rank(s.sp22, below);

  const size_t strip0 = (size_t)y0 * W;
  const float* gu_in = uv_in + (size_t)b * 2 * hw + strip0;
  float* gu = uv_out + (size_t)b * 2 * hw + strip0;
  float* gv = gu + hw;

  // Where the strip's I1wx, I1wy and rho_c lie, cs floats apart: shared
  // memory, or the strip's rows of scratch.  The prologue writes them.
  float* cw = consts;
  size_t cs = cap;
  if constexpr (!SC) {
    cw = scratch + (size_t)b * 3 * hw + strip0;
    cs = hw;
  }
  s.cwx = cw;
  s.cwy = cw + cs;
  s.crho = cw + 2 * cs;

  float cth[PPT], cinv[PPT];
  constexpr int NF = (PPT + 15) / 16;
  unsigned long long flag_bits[NF] = {};   // 4 bits a pixel
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = tid + k * WNT;
    if (i < n)
      flag_bits[k / 16] |= (unsigned long long)edge_flags(i, W, s.rows)
                           << (4 * (k % 16));
  }
  for (int i = tid; i < n; i += WNT) {
    s.su[i] = gu_in[i];
    s.sv[i] = gu_in[hw + i];
  }

  for (int wp = 0; wp < g.warps; ++wp) {
    // What a fresh launch finds: the dual at zero, its halo row too.  The
    // barrier that ended the warp before has made the neighbours' last
    // stores into this block's halo rows visible; nobody stores there again
    // before the barrier below.
    for (int i = tid; i < n; i += WNT) {
      s.sp11[i] = 0.0f;
      s.sp21[i] = 0.0f;
    }
    for (int i = tid; i < W + n; i += WNT) {   // the halo row too
      s.sp12[i] = 0.0f;
      s.sp22[i] = 0.0f;
    }
    for (int i = tid; i < W; i += WNT) {       // read before it is first stored
      s.su[n + i] = 0.0f;                      // only where a select drops it
      s.sv[n + i] = 0.0f;
    }
    if (tid == 0) {
      s.sp11[-1] = 0.0f;
      s.sp21[-1] = 0.0f;
    }

    {
      // warp_prep.cu at the thread's own pixels, from the u, v the strip
      // holds: the sample of (I1, I1x, I1y) at p + (u, v) with coordinates
      // clamped as ops/kernels.bilinear_sample clamps them, grad and rho_c
      // in that kernel's order.  One pixel at a time: nothing of the
      // gather outlives its pixel.
      const float* I1 = i13 + (size_t)b * 3 * hw;
      const float* I1x = I1 + hw;
      const float* I1y = I1x + hw;
      const float* gi0 = i0 + (size_t)b * hw + strip0;
      const int t0 = opaque(tid);
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const int i = t0 + k * WNT;
        float gr = 0.0f;
        if (i < n) {
          const int r = i / W, x = i - r * W;
          const int y = y0 + r;
          const float u0 = s.su[i], v0 = s.sv[i];
          const float ys = fminf(fmaxf((float)y + v0, 0.0f), (float)(H - 1));
          const float xs = fminf(fmaxf((float)x + u0, 0.0f), (float)(W - 1));
          const int yi = min(max((int)floorf(ys), 0), H - 2);
          const int xi = min(max((int)floorf(xs), 0), W - 2);
          const float fy = ys - (float)yi;
          const float fx = xs - (float)xi;
          const float I1w = va::lerp2(I1, W, yi, xi, fy, fx);
          const float I1wx = va::lerp2(I1x, W, yi, xi, fy, fx);
          const float I1wy = va::lerp2(I1y, W, yi, xi, fy, fx);
          gr = I1wx * I1wx + I1wy * I1wy;
          cw[i] = I1wx;
          cw[cs + i] = I1wy;
          cw[2 * cs + i] = I1w - I1wx * u0 - I1wy * v0 - gi0[i];
        }
        cth[k] = g.l_t * gr;
        cinv[k] = 1.0f / fmaxf(gr, 1e-10f);
        asm volatile("" ::: "memory");
      }
    }
    cluster.sync();

    int rounds = 0;
    for (int o = 0; o < g.outer; ++o) {
      if (g.median_k > 1) {             // uniform over the cluster
        if (g.median_k == 3)
          median_to_global<3>(cluster, s, y0, n, H, RS, gu, gv);
        else
          median_to_global<5>(cluster, s, y0, n, H, RS, gu, gv);
        cluster.sync();                 // every block has read its neighbours
        for (int i = tid; i < n; i += WNT) {   // each thread: what it wrote
          s.su[i] = gu[i];
          s.sv[i] = gv[i];
        }
        // No barrier: phase A reads u, v of the thread's own pixels only.
      }
      for (int it = 0; it < g.inner; ++it) {
        const bool last = it == g.inner - 1;
        float e = 0.0f;
        const int t0 = opaque(tid);
        unsigned long long fb[NF];
#pragma unroll
        for (int j = 0; j < NF; ++j) fb[j] = opaque(flag_bits[j]);
        // The 4 flag bits of the thread's k-th pixel.
        auto flags_of = [&fb](int k) {
          return (unsigned)(fb[k / 16] >> (4 * (k % 16))) & 15u;
        };
        if (last) {                     // uniform
#pragma unroll
          for (int k = 0; k < PPT; ++k) {
            const int i = t0 + k * WNT;
            if (i < n)
              e += step_a<true>(s, i, flags_of(k), cth[k], cinv[k]);
          }
#pragma unroll
          for (int d = 16; d > 0; d >>= 1)
            e += __shfl_xor_sync(0xffffffffu, e, d);
          if ((tid & 31) == 0) red[tid >> 5] = e;
        } else {
#pragma unroll
          for (int k = 0; k < PPT; ++k) {
            const int i = t0 + k * WNT;
            if (i < n)
              step_a<false>(s, i, flags_of(k), cth[k], cinv[k]);
          }
        }
        cluster.sync();
        if (last && tid == 0) {
          float t = 0.0f;
          for (int w = 0; w < WNW; ++w) t += red[w];
          *bsum = t;
        }
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const int i = t0 + k * WNT;
          if (i < n) step_b(s, i, flags_of(k));
        }
        cluster.sync();
      }
      ++rounds;
      float total = 0.0f;               // the same sum in every thread
      for (int r = 0; r < g.CL; ++r)
        total += *cluster.map_shared_rank(bsum, r);
      if (total / g.n_px < g.eps2) break;
    }
    if (rounds_out != nullptr && rank == 0 && tid == 0)
      rounds_out[b * g.warps + wp] = rounds;
  }

  // The barrier that ended the last phase has made every strip's u, v
  // final: the scale ends with the median once more, which reads the
  // neighbours' rows as the round-opening one does, and writes the output.
  if (g.median_k == 3) {
    median_to_global<3>(cluster, s, y0, n, H, RS, gu, gv);
  } else if (g.median_k == 5) {
    median_to_global<5>(cluster, s, y0, n, H, RS, gu, gv);
  } else {
    for (int i = tid; i < n; i += WNT) {
      gu[i] = s.su[i];
      gv[i] = s.sv[i];
    }
  }
  cluster.sync();   // no block leaves while a neighbour may still read it
}

using WarpKernel = void (*)(const float*, const float*, const float*, float*,
                            float*, int*, WarpGeom);

struct Variant {
  int ppt;             // pixels a thread at most
  bool sc;             // I1wx, I1wy, rho_c in shared memory
  WarpKernel kernel;
  int smem_set;        // dynamic shared memory the kernel has opted in to
  bool wide_set;       // opted in to non-portable cluster sizes
};

Variant variants[] = {
    {4, true, pd_warp_kernel<4, true>, 0, false},
    {8, true, pd_warp_kernel<8, true>, 0, false},
    {13, true, pd_warp_kernel<13, true>, 0, false},
    {16, false, pd_warp_kernel<16, false>, 0, false},
    {20, false, pd_warp_kernel<20, false>, 0, false},
};

int strip_rows(int H, int cl) { return va::cdiv(H, cl); }

// Six planes of the strip, a halo row beside u, v, p12 and p22, and the
// scratch; then three planes of constants where they fit as well.
long long state_bytes(int H, int W, int cl) {
  return ((6LL * strip_rows(H, cl) + 4) * W + SCRATCH) *
         (long long)sizeof(float);
}

long long consts_bytes(int H, int W, int cl) {
  return 3LL * strip_rows(H, cl) * W * (long long)sizeof(float);
}

bool consts_fit(int H, int W, int cl) {
  return state_bytes(H, W, cl) + consts_bytes(H, W, cl) <= MAX_SMEM;
}

Variant* pick(int H, int W, int cl) {
  const int ppt = va::cdiv(strip_rows(H, cl) * W, WNT);
  const bool sc = consts_fit(H, W, cl);
  for (Variant& v : variants)
    if (v.sc == sc && ppt <= v.ppt) return &v;
  return nullptr;
}

// Whether the strips of an (H, W) image fit a block's shared memory in a
// cluster of cl blocks, cl one of 1, 2, 4, 8 and 16.
bool fits(int H, int W, int cl) {
  return H >= 1 && W >= 1 &&
         (cl == 1 || cl == 2 || cl == 4 || cl == 8 || cl == 16) &&
         state_bytes(H, W, cl) <= MAX_SMEM && pick(H, W, cl) != nullptr;
}

int smem_of(int H, int W, int cl) {
  return (int)(state_bytes(H, W, cl) +
               (consts_fit(H, W, cl) ? consts_bytes(H, W, cl) : 0));
}

// Above 48 KB a kernel must opt in to its dynamic shared memory, and above
// eight blocks to a cluster size that is not portable.
cudaError_t opt_in(Variant* v, int smem, int cl) {
  if (smem > v->smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        v->kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    v->smem_set = smem;
  }
  if (cl > 8 && !v->wide_set) {
    cudaError_t err = cudaFuncSetAttribute(
        v->kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    v->wide_set = true;
  }
  return cudaSuccess;
}

// A launch configuration of `cl`-block clusters, one per image; `attr`
// must outlive its use.
cudaLaunchConfig_t cluster_config(int cl, int B, int smem, cudaStream_t s,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cl, B);
  config.blockDim = dim3(WNT);
  config.dynamicSmemBytes = smem;
  config.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cl;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

}  // namespace

// Bytes of dynamic shared memory a block needs for an (H, W) image in a
// cluster of `cl` blocks (the state, and the constants where they fit
// beside it), or -1 where the strips do not fit at that size.
VA_EXPORT int va_pd_scale_smem(int H, int W, int cl) {
  return fits(H, W, cl) ? smem_of(H, W, cl) : -1;
}

// Clusters of `cl` blocks (1, 2, 4, 8 or 16) of this kernel that the card
// can hold at once at (H, W), or the negated CUDA error; the strips of
// (H, W) must fit at that size.
VA_EXPORT int va_pd_warp_max_clusters(int H, int W, int B, int cl) {
  if (B < 1 || !fits(H, W, cl)) return -(int)cudaErrorInvalidValue;
  const int smem = smem_of(H, W, cl);
  Variant* v = pick(H, W, cl);
  cudaError_t err = opt_in(v, smem, cl);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -(int)err;
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config = cluster_config(cl, B, smem, 0, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, (void*)v->kernel, &config);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -(int)err;
  }
  return clusters;
}

// One pyramid scale in clusters of `blocks` blocks (1, 2, 4, 8 or 16; the
// strips of (H, W) must fit at that size).  i13: (B, 3, H, W) planes I1,
// I1x, I1y; i0: (B, H, W); uv_in, uv_out: (B, 2, H, W), distinct buffers;
// scratch: (B, 3, H, W), used only where the strip's constants do not fit
// shared memory at that size (else it may be null); rounds_out: null, or
// (B, warps) int32 that receives the rounds each image ran in each warp.
// median_k in {0, 3, 5}; after the last warp the median is applied once
// more.  H, W >= 2.
VA_EXPORT int va_pd_scale(const float* i13, const float* i0,
                          const float* uv_in, float* uv_out, float* scratch,
                          int* rounds_out, int B, int H, int W, int blocks,
                          int warps, int inner, int outer, int median_k,
                          float l_t, float theta, float taut, float eps2,
                          void* stream) {
  if (i13 == nullptr || i0 == nullptr || H < 2 || W < 2 ||
      !fits(H, W, blocks) ||
      (scratch == nullptr && !consts_fit(H, W, blocks)) || B < 1 ||
      warps < 1 || inner < 1 || outer < 0 ||
      (median_k != 0 && median_k != 3 && median_k != 5))
    return (int)cudaErrorInvalidValue;
  const int smem = smem_of(H, W, blocks);
  WarpGeom g;
  g.H = H;
  g.W = W;
  g.CL = blocks;
  g.RS = strip_rows(H, blocks);
  g.inner = inner;
  g.outer = outer;
  g.median_k = median_k;
  g.warps = warps;
  g.l_t = l_t;
  g.theta = theta;
  g.taut = taut;
  g.eps2 = eps2;
  g.n_px = (float)(H * W);
  Variant* v = pick(H, W, blocks);
  cudaError_t err = opt_in(v, smem, blocks);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch must not see it
    return (int)err;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config =
      cluster_config(blocks, B, smem, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&config, v->kernel, i13, i0, uv_in, uv_out,
                           scratch, rounds_out, g);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}
