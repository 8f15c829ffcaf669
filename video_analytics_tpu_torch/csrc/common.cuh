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

}  // namespace va
