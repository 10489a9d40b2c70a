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
// `iters` dependent steps of ~16 flops per pixel, each ending in a
// reduction and a scalar update.
//
// Design (klt_level.cu's structure, without its extraction and template):
// one warp per keypoint, kWarps keypoints per block, and no block barrier.
// Each warp owns its slice of dynamic shared memory, the target window
// and T, Ix, Iy (S^2 + 3 win^2 floats: 13.8 KB at S = 46, win = 21), and
// stages it with 4-byte cp.async (T/Ix/Iy rows of win = 21 floats are not
// 16-byte aligned). With 4 warps a block takes 55 KB at S = 46, and
// K = 512 keypoints make 128 blocks, one per SM on 128 of the 132 SMs,
// each SM running four independent chains, one per scheduler. G, b and
// err are summed with 5 xor-shuffle stages: every lane ends with the same
// bits (float addition commutes), so every lane updates q itself and the
// freeze decision is uniform across the warp. There is no thread-0 step
// and no barrier in the chain: an iteration is its pixel loop, the
// shuffles and a few scalar operations. The earlier design (one block
// of 256 threads per keypoint, a block reduction through shared memory,
// thread 0 updating q behind two barriers per iteration) took 1.2-1.3x
// this one's device time (PERF.md §6): with 14 pixels per lane an
// iteration's own work, not its barriers, is most of the chain. Unrolling
// the pixel loop by 4 moved it by 1 %.
//
// The bilinear weights, the four-tap blend and the update use the plain
// version's expressions with round-to-nearest intrinsics, so nvcc cannot
// contract them into FMAs and the sampled patch matches the plain version
// bit for bit. The sums run in another order (and their multiply-adds do
// contract), so this kernel is held to a tolerance, not bitwise.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // keypoints per block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int floats_per_warp(int S, int win) {
  return S * S + 3 * win * win;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

// Copy n contiguous floats into shared memory, lane-strided.
__device__ __forceinline__ void load(float* dst, const float* src, int n, int lane) {
  for (int i = lane; i < n; i += 32) cp_async4(dst + i, src + i);
}

// Row-major walk of lane, lane + 32, ... over an n x n grid, keeping the
// (row, column) pair without a division per step.
struct Walk {
  int r, c, dr, dc, n;
  __device__ Walk(int lane, int n_)
      : r(lane / n_), c(lane % n_), dr(32 / n_), dc(32 % n_), n(n_) {}
  __device__ void next() {
    c += dc;
    r += dr;
    if (c >= n) {
      c -= n;
      ++r;
    }
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
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
                  float* __restrict__ err_out, int K, int S, int win,
                  int iters, float eps, float hi) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarps + warp;
  if (k >= K) return;  // whole warps only; no block barrier follows
  const int n = win * win;
  float* s_tgt = smem + (size_t)warp * floats_per_warp(S, win);  // [S, S]
  float* s_T = s_tgt + S * S;                                     // [win, win]
  float* s_Ix = s_T + n;
  float* s_Iy = s_Ix + n;

  // The template's three planes first (G needs two of them), then the
  // target window, each its own commit group.
  load(s_T, T + (size_t)k * n, n, lane);
  load(s_Ix, Ix + (size_t)k * n, n, lane);
  load(s_Iy, Iy + (size_t)k * n, n, lane);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  load(s_tgt, tgt + (size_t)k * S * S, S * S, lane);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  float qx = fminf(fmaxf(q0[2 * k], 0.0f), hi);
  float qy = fminf(fmaxf(q0[2 * k + 1], 0.0f), hi);

  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncwarp();
  float gxx = 0.f, gxy = 0.f, gyy = 0.f;
  for (int i = lane; i < n; i += 32) {
    const float ix = s_Ix[i], iy = s_Iy[i];
    gxx += ix * ix;
    gxy += ix * iy;
    gyy += iy * iy;
  }
  gxx = warp_sum(gxx);
  gxy = warp_sum(gxy);
  gyy = warp_sum(gyy);
  const float det = __fsub_rn(__fmul_rn(gxx, gyy), __fmul_rn(gxy, gxy));
  const float inv_det = fabsf(det) > 1e-12f ? __fdiv_rn(1.0f, det) : 0.0f;

  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
  for (int it = 0; it < iters; ++it) {
    const float flx = floorf(qx), fly = floorf(qy);
    const int ix0 = (int)flx, iy0 = (int)fly;
    const float fx = __fsub_rn(qx, flx), fy = __fsub_rn(qy, fly);
    float bx = 0.f, by = 0.f;
    Walk w(lane, win);
    for (int i = lane; i < n; i += 32, w.next()) {
      const float dI =
          __fsub_rn(sample(s_tgt, S, iy0, ix0, w.r, w.c, fx, fy), s_T[i]);
      bx += dI * s_Ix[i];
      by += dI * s_Iy[i];
    }
    bx = warp_sum(bx);
    by = warp_sum(by);
    // dx = -(Gyy bx - Gxy by) inv_det;  dy = -(-Gxy bx + Gxx by) inv_det
    const float dx = __fmul_rn(
        -__fsub_rn(__fmul_rn(gyy, bx), __fmul_rn(gxy, by)), inv_det);
    const float dy = __fmul_rn(
        -__fadd_rn(__fmul_rn(-gxy, bx), __fmul_rn(gxx, by)), inv_det);
    qx = fminf(fmaxf(__fadd_rn(qx, dx), 0.0f), hi);
    qy = fminf(fmaxf(__fadd_rn(qy, dy), 0.0f), hi);
    if (__fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy))) < eps)
      break;  // frozen: q no longer changes
  }

  // Mean absolute residual at the final position.
  const float flx = floorf(qx), fly = floorf(qy);
  const int ix0 = (int)flx, iy0 = (int)fly;
  const float fx = __fsub_rn(qx, flx), fy = __fsub_rn(qy, fly);
  float e = 0.f;
  Walk w(lane, win);
  for (int i = lane; i < n; i += 32, w.next())
    e += fabsf(__fsub_rn(sample(s_tgt, S, iy0, ix0, w.r, w.c, fx, fy), s_T[i]));
  e = warp_sum(e);
  if (lane == 0) {
    q_out[2 * k] = qx;
    q_out[2 * k + 1] = qy;
    err_out[k] = __fdiv_rn(e, (float)n);
  }
}

}  // namespace

// Dynamic shared memory of one block, in bytes.
extern "C" int epivo_lk_iterate_smem(int S, int win) {
  return (int)(sizeof(float) * kWarps * floats_per_warp(S, win));
}

extern "C" int epivo_lk_iterate(const float* tgt, const float* T,
                                const float* Ix, const float* Iy,
                                const float* q0, float* q_out, float* err,
                                int K, int S, int win, int iters, float eps,
                                float hi, cudaStream_t stream) {
  const int smem = epivo_lk_iterate_smem(S, win);
  const cudaError_t e = cudaFuncSetAttribute(
      lk_iterate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (K + kWarps - 1) / kWarps;
  lk_iterate_kernel<<<grid, kThreads, smem, stream>>>(tgt, T, Ix, Iy, q0, q_out,
                                                      err, K, S, win, iters,
                                                      eps, hi);
  return (int)cudaGetLastError();
}
