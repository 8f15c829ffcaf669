// K-B tvl1_pd_step, with the per-image epsilon test in the launch that
// ends a round: the TV-L1 primal-dual solver of one warp, one launch per
// iteration.
//
// Replaces the solver body of video_analytics_tpu/ops/pallas/
// tvl1_solve.py: _solver_kernel (tvl1_solve_warp), _pd_solve_packed
// (tvl1_solve_warp_packed) and the solver half of _scale_kernel_packed
// (tvl1_scale_pallas).  Its CPU reference is flow/tvl1.py:_solve_warp.
//
// One primal-dual iteration, per pixel, in the reference's update order
// (tvl1_solve.py:135-160):
//   rho = rho_c + I1wx*u + I1wy*v
//   d   = l_t if rho < -l_t*grad, -l_t if rho > l_t*grad,
//         else -rho / max(grad, 1e-10)
//   un  = u + d*I1wx + theta * div(p11, p12)   (vn likewise with p21, p22)
//   p  <- (p + taut*grad(un)) / (1 + taut*|grad(un)|)
// with div the backward difference (first row/column pass through) and
// grad the forward difference (zero on the last row/column).
//
// Design.  The TPU kernel keeps a whole image's solver state resident in
// VMEM for all 300 iterations of a warp.  A 224^2 image's state is ~10
// f32 planes, ~2 MB, far over the 227 KB of shared memory an H100 block
// has.  A cluster of eight blocks holds it: that is tvl1_pd_warp.cu, the
// solver of every level that fits a cluster (flow/tvl1.level_solver).  This
// kernel is the solver of the levels that do not and are still under the
// reference's size rule for its banded solver (about 74,000 to 87,000
// pixels, e.g. 240x320 and 280^2).  It runs one launch per iteration over
// every image of the batch:
//   - each 32x8 block stages p with a one-pixel halo on the left and top
//     (for the divergence) in shared memory, computes (un, vn) for its
//     tile plus a one-pixel halo on the right and bottom (recomputing the
//     neighbour's values, so no exchange is needed), then updates p from
//     the forward gradient of that tile;
//   - the state ping-pongs between two buffers (the wrapper swaps them),
//     because neighbouring blocks read the old p and u;
//   - a per-image `active` flag in device memory gates the work: a
//     converged image's blocks only copy (u, v) forward, so its state
//     stays frozen with no host synchronisation (tvl1_solve.py:165-179);
//   - on an outer round's last inner step the kernel writes each block's
//     sum of (un-u)^2 + (vn-v)^2, reduced in a fixed tree order.  With
//     `count` the same launch then tests the image (the CUDA samples'
//     threadFenceReduction, va::arrive): each block of image b writes its
//     partial and counts itself in count[b]; the last to arrive sums the
//     image's partials in a fixed order (thread t takes t,
//     t + NT, ..., then the tree), writes err[b], clears active[b] when
//     sum / n_px < eps^2, and sets count[b] back to 0.  Every block of the
//     image read active[b] before it arrived, so the write races with
//     none of them; a frozen image's blocks return at once and its test
//     does not run.  No float atomics, so a run repeats bit for bit, and
//     an image's result does not depend on the batch it rides in.
//
// Bound on the H100: memory bandwidth.  Per pixel and iteration it reads
// 10 f32 (4 solver constants, u, v, 4 dual planes) and writes 6, ~64 B,
// for ~60 flops: ~48 MB per launch at 15 pairs of 224^2, much of which
// stays in the 50 MB L2 between launches.  What a request loses on this
// chain is the host's time for ~320 launches a warp, not the kernel's:
// tvl1_pd_warp.cu (one launch a scale) and tvl1_pd_chunk.cu (several
// iterations per launch, for the large planes) are the designs that
// remove it.

#include "common.cuh"

namespace {

__device__ __forceinline__ float block_sum(float v, float* red) {
  const int tid = threadIdx.y * va::TX + threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int s = va::NT / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  return red[0];
}

__global__ void __launch_bounds__(va::NT)
pd_step_kernel(const float* __restrict__ prep, const float* __restrict__ uv_in,
               const float* __restrict__ p_in, float* __restrict__ uv_out,
               float* __restrict__ p_out, int* active,
               float* __restrict__ partial, int* __restrict__ count,
               float* __restrict__ err, int H, int W, float l_t, float theta,
               float taut, float n_px, float eps2) {
  using va::TX;
  using va::TY;
  using va::NT;
  const int b = blockIdx.z;
  const size_t hw = (size_t)H * W;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int x = x0 + tx, y = y0 + ty;
  const bool inside = x < W && y < H;
  const float* u = uv_in + (size_t)b * 2 * hw;
  const float* v = u + hw;
  float* uo = uv_out + (size_t)b * 2 * hw;
  float* vo = uo + hw;

  if (!active[b]) {  // uniform over the block: frozen image, copy forward
    if (inside) {
      const size_t o = (size_t)y * W + x;
      uo[o] = u[o];
      vo[o] = v[o];
    }
    return;
  }

  const float* I1wx = prep + (size_t)b * 4 * hw;
  const float* I1wy = I1wx + hw;
  const float* grad = I1wy + hw;
  const float* rho_c = grad + hw;
  const float* pin = p_in + (size_t)b * 4 * hw;
  float* pout = p_out + (size_t)b * 4 * hw;

  // p11, p12, p21, p22 at rows y0-1..y0+TY, cols x0-1..x0+TX.
  __shared__ float sp[4][TY + 2][TX + 2];
  // un, vn at rows y0..y0+TY, cols x0..x0+TX.
  __shared__ float su[TY + 1][TX + 1];
  __shared__ float sv[TY + 1][TX + 1];
  __shared__ float red[NT];

  for (int i = tid; i < (TY + 2) * (TX + 2); i += NT) {
    const int r = i / (TX + 2), c = i % (TX + 2);
    const int gy = y0 - 1 + r, gx = x0 - 1 + c;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const size_t o = (size_t)gy * W + gx;
#pragma unroll
    for (int k = 0; k < 4; ++k) sp[k][r][c] = in ? pin[k * hw + o] : 0.0f;
  }
  __syncthreads();

  for (int i = tid; i < (TY + 1) * (TX + 1); i += NT) {
    const int r = i / (TX + 1), c = i % (TX + 1);
    const int gy = y0 + r, gx = x0 + c;
    if (gy >= H || gx >= W) continue;  // never read: gradient is 0 there
    const size_t o = (size_t)gy * W + gx;
    const float wx = I1wx[o], wy = I1wy[o], g = grad[o];
    const float uu = u[o], vv = v[o];
    const float rho = rho_c[o] + wx * uu + wy * vv;
    const float th = l_t * g;
    const float inv_grad = 1.0f / fmaxf(g, 1e-10f);
    const float d = rho < -th ? l_t : (rho > th ? -l_t : -rho * inv_grad);
    const float v1 = uu + d * wx;
    const float v2 = vv + d * wy;
    const int R = r + 1, C = c + 1;
    const float d11 = gx == 0 ? sp[0][R][C] : sp[0][R][C] - sp[0][R][C - 1];
    const float d12 = gy == 0 ? sp[1][R][C] : sp[1][R][C] - sp[1][R - 1][C];
    const float d21 = gx == 0 ? sp[2][R][C] : sp[2][R][C] - sp[2][R][C - 1];
    const float d22 = gy == 0 ? sp[3][R][C] : sp[3][R][C] - sp[3][R - 1][C];
    su[r][c] = v1 + theta * (d11 + d12);
    sv[r][c] = v2 + theta * (d21 + d22);
  }
  __syncthreads();

  float e = 0.0f;
  if (inside) {
    const size_t o = (size_t)y * W + x;
    const float un = su[ty][tx], vn = sv[ty][tx];
    if (partial != nullptr) {
      const float du = un - u[o], dv = vn - v[o];
      e = du * du + dv * dv;
    }
    const float ux = x < W - 1 ? su[ty][tx + 1] - un : 0.0f;
    const float uy = y < H - 1 ? su[ty + 1][tx] - un : 0.0f;
    const float vx = x < W - 1 ? sv[ty][tx + 1] - vn : 0.0f;
    const float vy = y < H - 1 ? sv[ty + 1][tx] - vn : 0.0f;
    const float inv_u = 1.0f / (1.0f + taut * sqrtf(ux * ux + uy * uy));
    const float inv_v = 1.0f / (1.0f + taut * sqrtf(vx * vx + vy * vy));
    pout[o] = (sp[0][ty + 1][tx + 1] + taut * ux) * inv_u;
    pout[hw + o] = (sp[1][ty + 1][tx + 1] + taut * uy) * inv_u;
    pout[2 * hw + o] = (sp[2][ty + 1][tx + 1] + taut * vx) * inv_v;
    pout[3 * hw + o] = (sp[3][ty + 1][tx + 1] + taut * vy) * inv_v;
    uo[o] = un;
    vo[o] = vn;
  }
  if (partial == nullptr) return;   // uniform
  const int n_part = gridDim.x * gridDim.y;
  const float s = block_sum(e, red);
  __shared__ int last;
  if (tid == 0) {
    partial[(size_t)b * n_part + blockIdx.y * gridDim.x + blockIdx.x] = s;
    if (count != nullptr) last = va::arrive(count + b) == n_part - 1;
  }
  if (count == nullptr) return;     // uniform
  __syncthreads();                  // also: every thread has read red[0]
  if (!last) return;
  float t = 0.0f;
  for (int i = tid; i < n_part; i += NT)
    t += __ldcg(partial + (size_t)b * n_part + i);
  t = block_sum(t, red);
  if (tid == 0) {
    const float m = t / n_px;
    err[b] = m;
    if (m < eps2) active[b] = 0;
    count[b] = 0;
  }
}

}  // namespace

// prep: (B, 4, H, W) I1wx, I1wy, grad, rho_c; uv_in/uv_out: (B, 2, H, W);
// p_in/p_out: (B, 4, H, W) p11, p12, p21, p22; active: (B,) int32;
// partial: (B, cdiv(W, TX) * cdiv(H, TY)), one sum per block, or null when
// the step needs no error; count: null, or the ε test in this launch
// (partial given): count (B,) int32, zero, and left zero; err (B,) float32,
// the mean squared update of each image still active, whose flag is
// cleared where it is under eps2.
VA_EXPORT int va_pd_step(const float* prep, const float* uv_in,
                         const float* p_in, float* uv_out, float* p_out,
                         int* active, float* partial, int* count, float* err,
                         int B, int H, int W, float l_t, float theta,
                         float taut, float eps2, void* stream) {
  if (count != nullptr && (partial == nullptr || err == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 block(va::TX, va::TY);
  const dim3 grid(va::cdiv(W, va::TX), va::cdiv(H, va::TY), B);
  pd_step_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      prep, uv_in, p_in, uv_out, p_out, active, partial, count, err, H, W,
      l_t, theta, taut, (float)((double)H * W), eps2);
  return (int)cudaGetLastError();
}
