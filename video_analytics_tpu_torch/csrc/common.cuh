// Shared definitions of the port's CUDA kernels (built for sm_90a into
// one shared library with a plain C interface; see ops/cuda/_build.py).
//
// Every entry point launches on the stream it is given, allocates
// nothing, does not synchronise, and returns cudaGetLastError() so the
// Python wrapper raises on a launch that was refused.
//
// The library is compiled with -fmad=false: each multiply and add rounds
// on its own, as in the plain PyTorch versions the kernels are held
// against, so the kernels agree with them to the last bit wherever the
// operation order is the same.  Letting nvcc contract to FMA is later
// tuning work.
#pragma once

#include <cuda_runtime.h>

#define VA_EXPORT extern "C" __attribute__((visibility("default")))

namespace va {

// Thread-block tile of the stencil kernels: 32 columns (one warp, so a
// row of the tile is one coalesced 128-byte access) by 8 rows.
constexpr int TX = 32;
constexpr int TY = 8;
constexpr int NT = TX * TY;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Correlation taps, passed to a kernel by value: the host's float array
// copied into the launch parameters, so no tap lives in device memory.  Only
// fb_window_solve.cu's instantiation for the default fifteen-tap window
// reads them so, as compile-time operands; every other count (the blur,
// the expansion, a longer window) is read from device memory into shared
// memory, and no kernel bounds the count by this.
constexpr int MAX_TAPS = 31;
struct Taps {
  float k[MAX_TAPS];
  int n;
};
inline Taps make_taps(const float* k, int n) {
  Taps t;
  t.n = n;
  for (int i = 0; i < MAX_TAPS; ++i) t.k[i] = i < n ? k[i] : 0.0f;
  return t;
}

// Bilinear sample of plane P (row length W) at (y0 + fy, x0 + fx), in
// the operation order of ops/kernels.bilinear_sample.
__device__ __forceinline__ float lerp2(const float* __restrict__ P, int W,
                                       int y0, int x0, float fy, float fx) {
  const float p00 = P[y0 * W + x0];
  const float p01 = P[y0 * W + x0 + 1];
  const float p10 = P[(y0 + 1) * W + x0];
  const float p11 = P[(y0 + 1) * W + x0 + 1];
  const float top = p00 * (1.0f - fx) + p01 * fx;
  const float bot = p10 * (1.0f - fx) + p11 * fx;
  return top * (1.0f - fy) + bot * fy;
}

// A block's arrival at a count of blocks, by the thread that wrote what
// the block leaves for the last one (threadFenceReduction of the CUDA
// samples, with one acq_rel atomic in place of its fence): the count
// before it.  Release: what this thread wrote before is visible to the
// block that counts after it.  Acquire: where this block is the last, what
// the others wrote before they counted is visible to this thread, and to
// the block's other threads after a barrier.
__device__ __forceinline__ int arrive(int* count) {
  int before;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(before) : "l"(count) : "memory");
  return before;
}

}  // namespace va
