// bn_act: eval-mode BatchNorm, the optional residual add after it and the
// optional ReLU, in one pass over channels-last memory, in place.
//
// Replaces no TPU kernel: the reference leaves BatchNorm to XLA, which
// fuses it into its neighbours, where ATen runs it as three passes (the
// norm, the add, the clamp), each reading and writing the whole
// activation.  Added for the CNNs' eval forward (models/resnet.norm_act:
// ResNet's and R(2+1)D's stems, blocks and shortcut projections).
//
// What it computes, per element x of channel c (float32 arithmetic, each
// operation rounded on its own under -fmad=false):
//   t = round(((x - mean[c]) * invstd[c]) * weight[c] + bias[c]),
//     invstd[c] = 1 / sqrtf(var[c] + eps)          (one rounding to T)
//   t = round(t + residual)                        (with a residual)
//   t = t < 0 ? 0 : t                              (with the ReLU)
// The ReLU may be left out only where no residual is added: every
// residual site of the models ends with it.
// the operations and roundings of ops/cuda/bn_act.bn_act_plain, so the
// two agree to the bit.  T is bfloat16 or float32.
//
// Layout.  In channels-last memory (NHWC or NDHWC, dense) the activation
// is a (rows, C) matrix stored row after row: a flat array whose element
// i has channel i mod C.  A thread reads and writes 16 bytes at a time (8
// bfloat16 or 4 float32 elements, neighbouring threads on neighbouring
// vectors) and walks the array with a stride that is a multiple of the
// period P = C / gcd(C, V) of the vectors' channel pattern, so every
// vector a thread touches starts at the same channel: the thread reads
// its V channels' (mean, invstd, weight, bias) once, from shared memory
// into registers, and the loop reads no parameter at all.  Odd C (45,
// 921) only lengthens the period; the n mod V elements past the last
// whole vector take one thread each.
//
// Bound on the H100: the bytes.  A bfloat16 element is read and written
// once (4 bytes, 6 with a residual) for ~10 instructions; at R(2+1)D-34's
// stage 1 (16 x 144 x 32 x 56^2) that is 0.92 GB, 276 us at 3.35 TB/s.
// The design keeps the card's memory busy: each thread keeps BN_INFLIGHT
// bytes of loads in flight, and the grid fills every SM.

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BN_NT = 256;
// Bytes of loads a thread keeps in flight: 8 vectors, or 4 and their
// residuals.  At stage 1's shape on an H100, 4 or 2 vectors without a
// residual took 20-25 % longer, and 8 with one 7-9 % longer.
constexpr int BN_INFLIGHT = 128;
// The most channels a launch takes: a float4 a channel in the 48 KB of
// shared memory a block has without opting in.  ops/cuda/bn_act's
// MAX_CHANNELS mirrors it (tests/test_torch_bn_act.py holds the two equal).
constexpr int BN_MAX_C = 3072;

template <typename T>
struct alignas(16) Pack {
  static constexpr int V = 16 / sizeof(T);
  T e[V];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One element; p = (mean, invstd, weight, bias) of its channel.
template <typename T, bool RES, bool RELU>
__device__ __forceinline__ T bn_one(T x, T r, float4 p) {
  T y = from_f<T>(((to_f(x) - p.x) * p.y) * p.z + p.w);
  if (RES) y = from_f<T>(to_f(y) + to_f(r));
  if (RELU && to_f(y) < 0.0f) y = from_f<T>(0.0f);
  return y;
}

template <typename T, bool RES, bool RELU>
__device__ __forceinline__ void bn_pack(Pack<T>& a, const Pack<T>& r,
                                        const float4* p) {
#pragma unroll
  for (int k = 0; k < Pack<T>::V; ++k)
    a.e[k] = bn_one<T, RES, RELU>(a.e[k], r.e[k], p[k]);
}

// x: n elements, in place; res: n elements or null.  `stride` (in
// vectors) is a multiple of the period; threads from `stride` on only
// fill shared memory and take the tail.
template <typename T, bool RES, bool RELU>
__global__ void __launch_bounds__(BN_NT)
bn_act_kernel(T* x, const T* __restrict__ res,
              const float* __restrict__ mean, const float* __restrict__ var,
              const float* __restrict__ weight,
              const float* __restrict__ bias, float eps, long long n, int C,
              long long stride) {
  constexpr int V = Pack<T>::V;
  extern __shared__ float4 sp[];
  for (int c = threadIdx.x; c < C; c += BN_NT)
    sp[c] = make_float4(mean[c], 1.0f / sqrtf(var[c] + eps), weight[c],
                        bias[c]);
  __syncthreads();

  const long long g = (long long)blockIdx.x * BN_NT + threadIdx.x;
  const long long nv = n / V;
  if (g < stride) {
    float4 p[V];
    int c = (int)((g * V) % C);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      p[k] = sp[c];
      c = c + 1 == C ? 0 : c + 1;
    }
    // The vectors g, g + stride, ... below nv: `left` of them, U in
    // flight at a time, the last few one by one.
    constexpr int U = RES ? BN_INFLIGHT / 32 : BN_INFLIGHT / 16;
    Pack<T>* px = reinterpret_cast<Pack<T>*>(x) + g;
    const Pack<T>* pr = RES ? reinterpret_cast<const Pack<T>*>(res) + g
                            : nullptr;
    long long left = g < nv ? (nv - 1 - g) / stride + 1 : 0;
    for (; left >= U; left -= U) {
      Pack<T> a[U], r[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        a[u] = px[u * stride];
        if (RES) r[u] = pr[u * stride];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        bn_pack<T, RES, RELU>(a[u], RES ? r[u] : a[u], p);
        px[u * stride] = a[u];
      }
      px += U * stride;
      if (RES) pr += U * stride;
    }
    for (; left > 0; --left) {
      Pack<T> a = *px, r;
      if (RES) r = *pr;
      bn_pack<T, RES, RELU>(a, RES ? r : a, p);
      *px = a;
      px += stride;
      if (RES) pr += stride;
    }
  }
  const long long i = nv * V + g;
  if (i < n) x[i] = bn_one<T, RES, RELU>(x[i], RES ? res[i] : x[i],
                                          sp[(int)(i % C)]);
}

long long gcd(long long a, long long b) {
  while (b != 0) {
    const long long t = a % b;
    a = b;
    b = t;
  }
  return a;
}

template <typename T, bool RES, bool RELU>
int launch(void* x, const void* res, const float* mean, const float* var,
           const float* weight, const float* bias, float eps, long long n,
           int C, cudaStream_t s) {
  constexpr int V = Pack<T>::V;
  auto kernel = bn_act_kernel<T, RES, RELU>;
  static int sms = 0, per_sm = 0;   // SMs; blocks an SM holds at BN_MAX_C
  if (per_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, BN_NT, BN_MAX_C * sizeof(float4));
    if (err != cudaSuccess) return (int)err;
  }
  const long long period = C / gcd(C, V);
  long long threads = n / V;
  if (threads > (long long)sms * per_sm * BN_NT)
    threads = (long long)sms * per_sm * BN_NT;
  if (threads < period) threads = period;
  const long long blocks = (threads + BN_NT - 1) / BN_NT;
  const long long stride = blocks * BN_NT / period * period;
  kernel<<<(unsigned)blocks, BN_NT, C * sizeof(float4), s>>>(
      static_cast<T*>(x), static_cast<const T*>(res), mean, var, weight, bias,
      eps, n, C, stride);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(void* x, const void* res, const float* mean, const float* var,
             const float* weight, const float* bias, float eps, long long n,
             int C, int relu, cudaStream_t s) {
  if (res != nullptr)   // a block's residual add: the ReLU follows it
    return launch<T, true, true>(x, res, mean, var, weight, bias, eps, n, C,
                                 s);
  return relu ? launch<T, false, true>(x, res, mean, var, weight, bias, eps,
                                       n, C, s)
              : launch<T, false, false>(x, res, mean, var, weight, bias, eps,
                                        n, C, s);
}

}  // namespace

// x: n elements of a dense channels-last tensor with C channels (n a
// multiple of C), bfloat16 (bf16 = 1) or float32, overwritten with the
// result; res: n elements of the same type and layout, or null (relu = 0
// only without res); mean, var, weight, bias: C float32 each.  x and res
// 16-byte aligned.
VA_EXPORT int va_bn_act(void* x, const void* res, const float* mean,
                        const float* var, const float* weight,
                        const float* bias, float eps, long long n, int C,
                        int bf16, int relu, void* stream) {
  if (C < 1 || C > BN_MAX_C || n < 0 || n % C != 0 ||
      (res != nullptr && !relu) ||
      ((uintptr_t)x | (uintptr_t)res) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch_t<__nv_bfloat16>(x, res, mean, var, weight, bias, eps,
                                        n, C, relu, s)
              : launch_t<float>(x, res, mean, var, weight, bias, eps, n, C,
                                relu, s);
}
