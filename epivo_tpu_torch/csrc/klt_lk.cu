// Lucas-Kanade iterations of one pyramid level, all keypoints at once.
//
// Replaces the TPU kernel epivo_tpu/frontend/pallas_klt.py::_lk_kernel
// (entry lk_iterate_pallas). Plain version and oracle:
// epivo_tpu_torch/frontend/klt.py::lk_iterate_plain.
//
// Per keypoint k: G = sum [Ix^2, IxIy; IxIy, Iy^2] over the template
// gradients, inv_det = 0 if |det| <= 1e-12. Then `iters` steps: sample the
// win x win patch P bilinearly at q in the S x S target window,
// b = sum (P - T) (Ix, Iy), delta = -G^-1 b, q <- clip(q + delta, 0, hi)
// unless frozen; a keypoint freezes once |delta| < eps. Outputs the final
// q and err = mean |P - T| at it.
//
// What bounds it on the H100: latency, not bytes or FLOPs. A keypoint
// reads (S*S + 3*win*win) floats once (14 KB at S = 46) and then runs
// `iters` dependent steps of ~10 flops per pixel, each ending in a block
// reduction and a scalar update.
//
// Design: one block of 256 threads per keypoint (keypoint-major [K, S, S];
// the reference's lane-major [S, S, K] layout is TPU-only). The target
// window and T/Ix/Iy live in shared memory for all iterations; each thread
// owns about two patch pixels. Sums are reduced with warp shuffles, then
// across the 8 warps through shared memory; thread 0 updates q and the
// freeze flag, and a barrier publishes them. A frozen keypoint stops
// iterating (its q no longer changes, so the result is the same).
//
// The bilinear weights, the four-tap blend and the update use the plain
// version's expressions with round-to-nearest intrinsics, so nvcc cannot
// contract them into FMAs and the sampled patch matches the plain version
// bit for bit. The sums run in another order (and their multiply-adds do
// contract), so this kernel is held to a tolerance, not bitwise.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Sum three per-thread values over the block; the totals are valid in
// thread 0 only. `red` holds 3 * kWarps floats.
__device__ void block_sum3(float& a, float& b, float& c, float* red) {
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
    c += __shfl_down_sync(0xffffffffu, c, off);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[warp] = a;
    red[kWarps + warp] = b;
    red[2 * kWarps + warp] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = red[0];
    b = red[kWarps];
    c = red[2 * kWarps];
    for (int w = 1; w < kWarps; ++w) {
      a += red[w];
      b += red[kWarps + w];
      c += red[2 * kWarps + w];
    }
  }
}

// Bilinear sample of the win x win patch pixel (r, c) at integer corner
// (iy, ix) and fractions (fx, fy): the plain version's four-tap blend
//   a00 (1-fx)(1-fy) + a01 fx (1-fy) + a10 (1-fx) fy + a11 fx fy.
__device__ __forceinline__ float sample(const float* win_s, int S, int iy,
                                        int ix, int r, int c, float fx,
                                        float fy) {
  const float* a = win_s + (iy + r) * S + ix + c;
  const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
  float t = __fmul_rn(__fmul_rn(a[0], gx), gy);
  t = __fadd_rn(t, __fmul_rn(__fmul_rn(a[1], fx), gy));
  t = __fadd_rn(t, __fmul_rn(__fmul_rn(a[S], gx), fy));
  return __fadd_rn(t, __fmul_rn(__fmul_rn(a[S + 1], fx), fy));
}

__global__ void __launch_bounds__(kThreads)
lk_iterate_kernel(const float* __restrict__ tgt, const float* __restrict__ T,
                  const float* __restrict__ Ix, const float* __restrict__ Iy,
                  const float* __restrict__ q0, float* __restrict__ q_out,
                  float* __restrict__ err_out, int S, int win, int iters,
                  float eps, float hi) {
  extern __shared__ float smem[];
  const int n = win * win;
  float* s_tgt = smem;          // [S * S]
  float* s_T = s_tgt + S * S;   // [n]
  float* s_Ix = s_T + n;        // [n]
  float* s_Iy = s_Ix + n;       // [n]
  __shared__ float red[3 * kWarps];
  __shared__ float s_q[2];
  __shared__ int s_done;
  __shared__ float s_G[4];      // Gxx, Gxy, Gyy, inv_det

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const float* tk = tgt + (size_t)k * S * S;
  for (int i = tid; i < S * S; i += kThreads) s_tgt[i] = tk[i];
  float gxx = 0.f, gxy = 0.f, gyy = 0.f;
  for (int i = tid; i < n; i += kThreads) {
    const size_t g = (size_t)k * n + i;
    const float ix = Ix[g], iy = Iy[g];
    s_T[i] = T[g];
    s_Ix[i] = ix;
    s_Iy[i] = iy;
    gxx += ix * ix;
    gxy += ix * iy;
    gyy += iy * iy;
  }
  block_sum3(gxx, gxy, gyy, red);
  if (tid == 0) {
    const float det = __fsub_rn(__fmul_rn(gxx, gyy), __fmul_rn(gxy, gxy));
    s_G[0] = gxx;
    s_G[1] = gxy;
    s_G[2] = gyy;
    s_G[3] = fabsf(det) > 1e-12f ? 1.0f / det : 0.0f;
    s_q[0] = fminf(fmaxf(q0[2 * k], 0.0f), hi);
    s_q[1] = fminf(fmaxf(q0[2 * k + 1], 0.0f), hi);
    s_done = 0;
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    if (s_done) break;  // uniform across the block
    const float qx = s_q[0], qy = s_q[1];
    const float flx = floorf(qx), fly = floorf(qy);
    const int ix0 = (int)flx, iy0 = (int)fly;
    const float fx = __fsub_rn(qx, flx), fy = __fsub_rn(qy, fly);
    float bx = 0.f, by = 0.f, unused = 0.f;
    for (int i = tid; i < n; i += kThreads) {
      const int r = i / win, c = i - r * win;
      const float dI = __fsub_rn(sample(s_tgt, S, iy0, ix0, r, c, fx, fy), s_T[i]);
      bx += dI * s_Ix[i];
      by += dI * s_Iy[i];
    }
    block_sum3(bx, by, unused, red);
    if (tid == 0) {
      const float Gxx = s_G[0], Gxy = s_G[1], Gyy = s_G[2], inv_det = s_G[3];
      // dx = -(Gyy bx - Gxy by) inv_det;  dy = -(-Gxy bx + Gxx by) inv_det
      const float dx = __fmul_rn(
          -__fsub_rn(__fmul_rn(Gyy, bx), __fmul_rn(Gxy, by)), inv_det);
      const float dy = __fmul_rn(
          -__fadd_rn(__fmul_rn(-Gxy, bx), __fmul_rn(Gxx, by)), inv_det);
      s_q[0] = fminf(fmaxf(__fadd_rn(qx, dx), 0.0f), hi);
      s_q[1] = fminf(fmaxf(__fadd_rn(qy, dy), 0.0f), hi);
      const float step = sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
      s_done = step < eps;
    }
    __syncthreads();
  }

  // Mean absolute residual at the final position.
  const float qx = s_q[0], qy = s_q[1];
  const float flx = floorf(qx), fly = floorf(qy);
  const int ix0 = (int)flx, iy0 = (int)fly;
  const float fx = __fsub_rn(qx, flx), fy = __fsub_rn(qy, fly);
  float e = 0.f, u1 = 0.f, u2 = 0.f;
  for (int i = tid; i < n; i += kThreads) {
    const int r = i / win, c = i - r * win;
    e += fabsf(__fsub_rn(sample(s_tgt, S, iy0, ix0, r, c, fx, fy), s_T[i]));
  }
  block_sum3(e, u1, u2, red);
  if (tid == 0) {
    q_out[2 * k] = qx;
    q_out[2 * k + 1] = qy;
    err_out[k] = e / (float)n;
  }
}

}  // namespace

extern "C" int epivo_lk_iterate(const float* tgt, const float* T,
                                const float* Ix, const float* Iy,
                                const float* q0, float* q_out, float* err,
                                int K, int S, int win, int iters, float eps,
                                float hi, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)S * S + 3 * (size_t)win * win);
  lk_iterate_kernel<<<K, kThreads, smem, stream>>>(tgt, T, Ix, Iy, q0, q_out,
                                                   err, S, win, iters, eps, hi);
  return (int)cudaGetLastError();
}
