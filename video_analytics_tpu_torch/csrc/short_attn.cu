// short_attn: multi-head self-attention over short sequences (at most 32
// tokens, heads of 64), read straight from the qkv projection's product
// before its bias, written as the (B, L, D) rows the output projection
// reads.
//
// Replaces no TPU kernel: the reference has no video transformer.  Added
// for TimeSformer's time half (models/timesformer.Attention), where each
// patch's sequence holds 8 tokens: cuDNN's flash kernel tiles 64 queries
// by 128 keys, so most of every tile is padding, and the call also needs
// the bias added in a pass of its own and the (B, H, L, 64) views
// permuted around it.
//
// What it computes, for each sequence b and head h:
//   qkv     = round(y + round(bias))     the bias rounded to bfloat16, then
//                                        the sum rounded: ops/layers.linear's
//                                        two roundings, bit for bit
//   s[i][j] = (q_i . k_j) * 0.125        products of the bfloat16 operands
//                                        summed in float32 (tensor cores),
//                                        scaled by 1 / sqrt(64) (exact)
//   w[i][j] = e[i][j] / sum_j e[i][j]    float32, e[i][j] = expf(s[i][j] -
//                                        max_j s[i][j]), keys past L left out
//   o_i     = round(sum_j w[i][j] v_j)   the weights float32, never rounded:
//                                        each is cut exactly into three
//                                        bfloat16 (hi + mid + lo) whose
//                                        products with v the tensor cores
//                                        sum in float32; one rounding to
//                                        bfloat16 at the end
// (ops/cuda/short_attn.short_attn_plain does the same in PyTorch's float32
// operations, in another summation order).
//
// Layout.  y is (B, L, 3D) bfloat16, contiguous, D = 64 H: row i of
// sequence b holds q (columns [0, D)), k ([D, 2D)) and v ([2D, 3D)), head
// h at 64 h within each, as the projection writes them.  out is (B, L, D),
// contiguous, head h at columns [64 h, 64 h + 64).
//
// Bound on the H100: the bytes.  The product is read and the output
// written once: at TimeSformer-Base's time half (3136 sequences, L = 8,
// D = 768) 154 MB, 46 us at 3.35 TB/s; the products are 0.6 GFLOP.  The
// design keeps the arithmetic out of the memory's way:
// - a block a sequence, a warp a head (H warps), no barrier between
//   warps; each warp copies its head's q, k and v rows (3 KB at L = 8)
//   into shared memory with 16-byte cp.async copies, all in flight at
//   once, so a block reads its sequence's whole slab together;
// - the bias, rounded to bfloat16 by the caller, is added in place, two
//   values a rounded fma (a * 1 + b);
// - the products run on the tensor cores (m16n8k16 mma; at L = 8 half of
//   each 16-row tile is empty): the scores stay in registers through the
//   softmax (a row's scores in one quad of lanes) and become the A operand
//   of the weighted sum, v its B operand through ldmatrix.trans;
// - tiles of rows past L are left out at compile time (one instance per
//   ceil(L / 8)), rows past L within a tile read row L - 1;
// - staged rows are padded by 16 bytes, so the rows a quad reads at one
//   column fall in different banks.
// Measured on an H100 at 700 W, L = 8, D = 768: 0.062 ms, 1.35x the
// bound; a device-to-device copy reaches 2.9 TB/s there (53 us for these
// bytes).

#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int SA_HD = 64;          // head width
constexpr int SA_MAX_L = 32;       // tokens a sequence
constexpr int SA_MAX_H = 16;       // heads: D <= 1024
constexpr int SA_RW = SA_HD + 8;   // bfloat16 a staged row (144 bytes)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// This thread's copies are complete.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Two floats rounded to bfloat16 (to nearest, ties to even), a in the low
// half.
__device__ __forceinline__ unsigned pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

// a + b on two bfloat16 pairs, each sum rounded once (a * 1 + b): the
// same bits as rounding float(a) + float(b), whose float32 sum of two
// bfloat16 values is exact or too far from a tie to move the rounding.
__device__ __forceinline__ unsigned add_bf16x2(unsigned a, unsigned b) {
  unsigned d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(a), "r"(0x3f803f80u), "r"(b));
  return d;
}

__device__ __forceinline__ unsigned lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// d += a·b on the tensor cores: A 16 x 16 (rows), B 16 x 8 (columns),
// bfloat16 operands, float32 sums.
__device__ __forceinline__ void mma(float* d, const unsigned* a, unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bfloat16 tiles, transposed: lane l gives the row address of
// tile l / 8, row l % 8; tile j lands in r[j].
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r,
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// A float32 weight as three bfloat16, w = hi + mid + lo exactly, so the
// weighted sum of v runs on the tensor cores without rounding the
// weights: hi keeps w's top 8 significant bits, mid the next 8 of the
// (exact) remainder, lo the last 8.  Each part is returned as float32 bits
// whose low half is 0, its bfloat16 in the high half.
__device__ __forceinline__ void split3(float w, unsigned* p) {
  const unsigned hi = __float_as_uint(w) & 0xffff0000u;
  const float r = w - __uint_as_float(hi);
  const unsigned mid = __float_as_uint(r) & 0xffff0000u;
  p[0] = hi;
  p[1] = mid;
  p[2] = __float_as_uint(r - __uint_as_float(mid));
}

// KT = ceil(L / 8): blocks of 8 keys; MT = ceil(L / 16): blocks of 16
// queries, and of 16 keys in the weighted sum.  A block of 8 rows (keys or
// queries) numbered n exists where n < KT; the ones past it are left out
// at compile time.  Rows past L within a block read row L - 1: their
// scores are never used, their keys are masked and weigh 0.
template <int KT>
__global__ void __launch_bounds__(32 * SA_MAX_H)
short_mha_kernel(const __nv_bfloat16* __restrict__ y,
                 const __nv_bfloat16* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, int L, int H) {
  constexpr int MT = (KT + 1) / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int D = H * SA_HD, PL = L * SA_RW;
  __nv_bfloat16* const q = reinterpret_cast<__nv_bfloat16*>(smem) + h * 3 * PL;
  __nv_bfloat16* const kp = q + PL;
  __nv_bfloat16* const vp = q + 2 * PL;
  const __nv_bfloat16* src = y + (size_t)blockIdx.x * L * 3 * D + h * SA_HD;

  // The head's q, k and v rows, 16 bytes a copy; then the bias (rounded
  // to bfloat16 by the caller), added with one more rounding.
#pragma unroll
  for (int p = 0; p < 3; ++p)
    for (int v = lane; v < 8 * L; v += 32)
      cp_async16(q + (p * L + (v >> 3)) * SA_RW + 8 * (v & 7),
                 src + (size_t)(v >> 3) * 3 * D + p * D + 8 * (v & 7));
  cp_async_wait_all();
#pragma unroll
  for (int p = 0; p < 3; ++p)
    for (int v = lane; v < 8 * L; v += 32) {
      uint4* e = reinterpret_cast<uint4*>(q + (p * L + (v >> 3)) * SA_RW +
                                          8 * (v & 7));
      const uint4 b = __ldg(reinterpret_cast<const uint4*>(
          bias + p * D + h * SA_HD + 8 * (v & 7)));
      uint4 x = *e;
      x.x = add_bf16x2(x.x, b.x);
      x.y = add_bf16x2(x.y, b.y);
      x.z = add_bf16x2(x.z, b.z);
      x.w = add_bf16x2(x.w, b.w);
      *e = x;
    }
  __syncwarp();

  // Scores: S = Q·Kᵀ, 16 widths a step.
  float s[MT][KT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < KT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < SA_HD / 16; ++ks) {
    const int c0 = 16 * ks + 2 * tq;
    unsigned a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const __nv_bfloat16* r0 = q + min(16 * mt + g, L - 1) * SA_RW + c0;
      a[mt][0] = lds32(r0);
      a[mt][2] = lds32(r0 + 8);
      if (2 * mt + 1 < KT) {
        const __nv_bfloat16* r1 = q + min(16 * mt + 8 + g, L - 1) * SA_RW + c0;
        a[mt][1] = lds32(r1);
        a[mt][3] = lds32(r1 + 8);
      } else {
        a[mt][1] = a[mt][3] = 0u;
      }
    }
#pragma unroll
    for (int nt = 0; nt < KT; ++nt) {
      const __nv_bfloat16* kr = kp + min(8 * nt + g, L - 1) * SA_RW + c0;
      const unsigned b0 = lds32(kr), b1 = lds32(kr + 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma(s[mt][nt], a[mt], b0, b1);
    }
  }

  // Softmax along each row: a row's scores lie in the 4 lanes of a quad,
  // 2 a lane an 8-key block (c0, c1 row g; c2, c3 row g + 8).
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (2 * mt + hr >= KT) continue;
      float m = -CUDART_INF_F;
#pragma unroll
      for (int nt = 0; nt < KT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[mt][nt][2 * hr + e];
          x = 8 * nt + 2 * tq + e < L ? x * 0.125f : -CUDART_INF_F;
          m = fmaxf(m, x);
        }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      float sum = 0.0f;
#pragma unroll
      for (int nt = 0; nt < KT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[mt][nt][2 * hr + e];
          x = expf(x - m);
          sum = sum + x;
        }
      sum = sum + __shfl_xor_sync(0xffffffffu, sum, 1);
      sum = sum + __shfl_xor_sync(0xffffffffu, sum, 2);
#pragma unroll
      for (int nt = 0; nt < KT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          s[mt][nt][2 * hr + e] = s[mt][nt][2 * hr + e] / sum;
    }

  // Outputs: O = W·V, 16 keys a step, each weight as three bfloat16 (the
  // smallest part first); the score fragments are the weights' A
  // fragments, v's B fragments come through ldmatrix.trans.
  float o[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][dt][e] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < MT; ++ks) {
    unsigned vb[2][8];   // keys +0..7, +8..15; 8 blocks of widths
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (2 * ks + half < KT) {
        const __nv_bfloat16* row =
            vp + min(16 * ks + 8 * half + (lane & 7), L - 1) * SA_RW +
            8 * (lane >> 3);
        ldmatrix_x4_trans(vb[half], row);
        ldmatrix_x4_trans(vb[half] + 4, row + 32);
      } else {
#pragma unroll
        for (int dt = 0; dt < 8; ++dt) vb[half][dt] = 0u;
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // a[part][j]: j = 0 row g keys +0..7, 1 row g + 8, 2 row g keys
      // +8..15, 3 row g + 8 (the A fragment's order); part 0 hi, 1 mid,
      // 2 lo.
      unsigned a[3][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nt = 2 * ks + (j >> 1);
        if (nt < KT && 2 * mt + (j & 1) < KT) {
          unsigned w0[3], w1[3];
          split3(s[mt][nt][2 * (j & 1)], w0);
          split3(s[mt][nt][2 * (j & 1) + 1], w1);
#pragma unroll
          for (int part = 0; part < 3; ++part)
            a[part][j] = __byte_perm(w0[part], w1[part], 0x7632);
        } else {
          a[0][j] = a[1][j] = a[2][j] = 0u;
        }
      }
#pragma unroll
      for (int part = 2; part >= 0; --part)
#pragma unroll
        for (int dt = 0; dt < 8; ++dt)
          mma(o[mt][dt], a[part], vb[0][dt], vb[1][dt]);
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = 16 * mt + 8 * hr + g;
      if (2 * mt + hr < KT && r < L) {
        __nv_bfloat16* orow =
            out + ((size_t)blockIdx.x * L + r) * D + h * SA_HD + 2 * tq;
#pragma unroll
        for (int dt = 0; dt < 8; ++dt)
          *reinterpret_cast<unsigned*>(orow + 8 * dt) =
              pack2(o[mt][dt][2 * hr], o[mt][dt][2 * hr + 1]);
      }
    }
}

template <int KT>
int launch(const void* y, const void* bias, void* out, int B, int L, int H,
           cudaStream_t s) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const long long bytes = 3LL * H * L * SA_RW * 2;
  if (bytes > optin) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(short_mha_kernel<KT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  short_mha_kernel<KT><<<B, 32 * H, (size_t)bytes, s>>>(
      static_cast<const __nv_bfloat16*>(y),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), L, H);
  return (int)cudaGetLastError();
}

}  // namespace

// y: (B, L, 3 * 64 H) bfloat16, contiguous; bias: 3 * 64 H bfloat16; out:
// (B, L, 64 H) bfloat16, contiguous; all three 16-byte aligned.
// 1 <= L <= 32, 1 <= H <= 16.  One block a sequence (B <= 2^31 - 1).
VA_EXPORT int va_short_attn(const void* y, const void* bias, void* out,
                            int B, int L, int H, void* stream) {
  if (B < 0 || L < 1 || L > SA_MAX_L || H < 1 || H > SA_MAX_H ||
      ((uintptr_t)y | (uintptr_t)bias | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch ((L + 7) / 8) {
    case 1: return launch<1>(y, bias, out, B, L, H, s);
    case 2: return launch<2>(y, bias, out, B, L, H, s);
    case 3: return launch<3>(y, bias, out, B, L, H, s);
    default: return launch<4>(y, bias, out, B, L, H, s);
  }
}
