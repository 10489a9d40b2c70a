// One pyramid level of pyramidal Lucas-Kanade for all keypoints, in one
// launch: window extraction, Scharr gradients, template sampling and the
// LK iterations.
//
// Replaces the TPU kernels epivo_tpu/frontend/pallas_klt.py::_extract_kernel
// (entries _extract_windows_batched / extract_windows_pallas) and
// pallas_klt.py::_lk_kernel (entry lk_iterate_pallas), together with the
// glue of klt._track_level around them. Plain version and oracle:
// epivo_tpu_torch/frontend/klt.py::track_level_composed(use_kernel=False).
//
// Per keypoint (b, k), with S = win + 2 margin + 1, h = (win - 1) / 2 and
// hi = S - win - 1 - 1e-3:
//   1. source origin o_s = clamp(rint(pt) - S/2, 0, (W - S, H - S)), where
//      rint rounds half to even as torch.round does; template corner
//      q_s = clamp(pt - o_s - h, 0, hi); effective centre c = o_s + q_s + h;
//   2. g = guess + (c - pt), and the target origin and corner q from g the
//      same way;
//   3. Scharr gx, gy at the (win + 1)^2 source-window pixels that the
//      template's bilinear taps read, edge-replicated at the window's own
//      border (as _grad_batch pads each window); T, Ix, Iy sampled at q_s;
//      G = sum [Ix^2, IxIy; IxIy, Iy^2] and ok = min_ev / win^2 > min_eig;
//   4. n_chunks chunks of LK steps in the target window with B3's freeze
//      rule (klt_lk.cu), re-centring g = q + o_t + h and reloading the
//      target window between chunks;
//   5. new_guess = pt + (g - c), ok, and err = mean |P - T| at the final q.
// Nothing of size [K, S, S] or [K, win, win] reaches device memory.
//
// What bounds it on the H100: at the finest level, bytes: it must read the
// two 376x1241 level images once (3.7 MB, 1.1 us at 3.35 TB/s) and does
// about 0.13 MFLOP per keypoint (0.07 GFLOP for 512 keypoints, 1 us at
// 67 TFLOP/s). On the small top levels, operations. In practice a level
// is latency bound: each keypoint runs up to `iters` dependent steps, each
// ending in a reduction.
//
// Design: one warp per keypoint, kWarps keypoints per block, and no block
// barrier. Each warp owns its slice of dynamic shared memory: the source
// and the target window (2 S^2 floats), T, Ix, Iy (3 win^2) and the
// gradient taps (2 (win + 1)^2): 26 KB at S = 46, win = 21, so a block of
// 4 warps takes 104 KB and two blocks fit an SM. The wrapper checks the
// block's budget against the 227 KB a block may use.
// Both windows are copied from the level images with 4-byte cp.async as
// soon as their origins are known (scalar arithmetic), one commit group
// each: the target window lands while the warp builds the template from
// the source window. Window origins are arbitrary, so rows are not 16-byte
// aligned; TMA would need a tensor map per level image built on the host
// and a box padded to a 16-byte inner size, for two windows of at most
// 8.5 KB per keypoint, so the simpler cp.async was chosen. Sums (G, b,
// err) are reduced with 5 xor-shuffle stages; every lane ends with the
// same bits (float addition commutes), so every lane computes the same
// update and the freeze decision is uniform across the warp.
//
// Exactness: the copies are exact, and the Scharr taps, the four-tap
// blends and every scalar update use round-to-nearest intrinsics in the
// plain version's order of terms (Scharr as ((0 + a0 k0) + a1 k1) + a2 k2,
// horizontal pass first), so nvcc contracts nothing and T, Ix, Iy and every
// sampled patch equal the plain version's bit for bit. Only the G, b and
// err sums run in another order, as in klt_lk.cu: the kernel is held to a
// tolerance, not bitwise.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // keypoints per block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

// Scharr taps (image.py): smoothing and derivative, exact in float32.
constexpr float kS0 = 3.0f / 16.0f, kS1 = 10.0f / 16.0f, kS2 = 3.0f / 16.0f;
constexpr float kD0 = -0.5f, kD1 = 0.0f, kD2 = 0.5f;

__host__ __device__ constexpr int floats_per_warp(int S, int win) {
  return 2 * S * S + 3 * win * win + 2 * (win + 1) * (win + 1);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// Copy the S x S window at (oy, ox) of a [H, W] image into shared memory
// (row-major, stride S) as one commit group.
__device__ void load_window(float* dst, const float* img, int W, int S, int oy,
                            int ox, int lane) {
  const float* src = img + (size_t)oy * W + ox;
  Walk w(lane, S);
  for (int i = lane; i < S * S; i += 32, w.next())
    cp_async4(dst + i, src + (size_t)w.r * W + w.c);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Window origin along one axis: clamp(rint(x) - S/2, 0, n - S). The clamp
// to +-1e8 keeps the integer conversion defined for wild coordinates.
__device__ __forceinline__ int origin(float x, int S, int n) {
  const int c = __float2int_rn(fminf(fmaxf(x, -1e8f), 1e8f));
  return min(max(c - S / 2, 0), n - S);
}

// Corner inside a window: clamp(x - o - h, 0, hi).
__device__ __forceinline__ float corner(float x, int o, float h, float hi) {
  return fminf(fmaxf(__fsub_rn(__fsub_rn(x, (float)o), h), 0.0f), hi);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// 3-tap filter ((0 + a0 k0) + a1 k1) + a2 k2, the plain version's order.
__device__ __forceinline__ float tap3(float a0, float a1, float a2, float k0,
                                      float k1, float k2) {
  float t = __fadd_rn(0.0f, __fmul_rn(a0, k0));
  t = __fadd_rn(t, __fmul_rn(a1, k1));
  return __fadd_rn(t, __fmul_rn(a2, k2));
}

// Both horizontal Scharr passes over one window row at columns (xm, x, xp):
// the derivative into d, the smoothing into s.
__device__ __forceinline__ void hrow(const float* row, int xm, int x, int xp,
                                     float& d, float& s) {
  const float a0 = row[xm], a1 = row[x], a2 = row[xp];
  d = tap3(a0, a1, a2, kD0, kD1, kD2);
  s = tap3(a0, a1, a2, kS0, kS1, kS2);
}

// Bilinear sample of patch pixel (r, c) at integer corner (iy, ix) of a
// row-major array with the given stride: klt_lk.cu's four-tap blend
//   a00 (1-fx)(1-fy) + a01 fx (1-fy) + a10 (1-fx) fy + a11 fx fy.
__device__ __forceinline__ float sample(const float* a_s, int stride, int iy,
                                        int ix, int r, int c, float fx,
                                        float fy) {
  const float* a = a_s + (iy + r) * stride + ix + c;
  const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
  float t = __fmul_rn(__fmul_rn(a[0], gx), gy);
  t = __fadd_rn(t, __fmul_rn(__fmul_rn(a[1], fx), gy));
  t = __fadd_rn(t, __fmul_rn(__fmul_rn(a[stride], gx), fy));
  return __fadd_rn(t, __fmul_rn(__fmul_rn(a[stride + 1], fx), fy));
}

__global__ void __launch_bounds__(kThreads)
track_level_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
                   const float* __restrict__ pt_src,
                   const float* __restrict__ guess,
                   float* __restrict__ new_guess,
                   unsigned char* __restrict__ ok_out,
                   float* __restrict__ err_out, int H, int W, int K, int S,
                   int win, int chunk_iters, int n_chunks, float eps,
                   float min_eig, float hi) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarps + warp;
  if (k >= K) return;  // whole warps only; no block barrier follows
  const int b = blockIdx.y;
  const int n = win * win, w1 = win + 1;
  float* s_src = smem + (size_t)warp * floats_per_warp(S, win);  // [S, S]
  float* s_tgt = s_src + S * S;                                   // [S, S]
  float* s_T = s_tgt + S * S;                                     // [win, win]
  float* s_Ix = s_T + n;
  float* s_Iy = s_Ix + n;
  float* s_gx = s_Iy + n;                                         // [w1, w1]
  float* s_gy = s_gx + w1 * w1;

  const size_t kk = (size_t)b * K + k;
  const float* im_s = src + (size_t)b * H * W;
  const float* im_t = tgt + (size_t)b * H * W;
  const float h = 0.5f * (float)(win - 1);

  // 1-2. Both origins are scalar arithmetic: issue both windows' copies.
  const float px = pt_src[2 * kk], py = pt_src[2 * kk + 1];
  const int osx = origin(px, S, W), osy = origin(py, S, H);
  load_window(s_src, im_s, W, S, osy, osx, lane);
  const float qsx = corner(px, osx, h, hi), qsy = corner(py, osy, h, hi);
  const float cx = __fadd_rn(__fadd_rn((float)osx, qsx), h);
  const float cy = __fadd_rn(__fadd_rn((float)osy, qsy), h);
  float gx = __fadd_rn(guess[2 * kk], __fsub_rn(cx, px));
  float gy = __fadd_rn(guess[2 * kk + 1], __fsub_rn(cy, py));
  int otx = origin(gx, S, W), oty = origin(gy, S, H);
  load_window(s_tgt, im_t, W, S, oty, otx, lane);

  // 3. Template from the source window (its group is the older one).
  cp_async_wait<1>();
  __syncwarp();
  const float flsx = floorf(qsx), flsy = floorf(qsy);
  const int ixs = (int)flsx, iys = (int)flsy;
  const float fxs = __fsub_rn(qsx, flsx), fys = __fsub_rn(qsy, flsy);
  {
    Walk w(lane, w1);
    for (int i = lane; i < w1 * w1; i += 32, w.next()) {
      const int y = iys + w.r, x = ixs + w.c;
      const int xm = max(x - 1, 0), xp = min(x + 1, S - 1);
      float hd0, hd1, hd2, hs0, hs1, hs2;
      hrow(s_src + max(y - 1, 0) * S, xm, x, xp, hd0, hs0);
      hrow(s_src + y * S, xm, x, xp, hd1, hs1);
      hrow(s_src + min(y + 1, S - 1) * S, xm, x, xp, hd2, hs2);
      s_gx[i] = tap3(hd0, hd1, hd2, kS0, kS1, kS2);
      s_gy[i] = tap3(hs0, hs1, hs2, kD0, kD1, kD2);
    }
  }
  __syncwarp();
  float gxx = 0.f, gxy = 0.f, gyy = 0.f;
  {
    Walk w(lane, win);
    for (int i = lane; i < n; i += 32, w.next()) {
      const float ix = sample(s_gx, w1, 0, 0, w.r, w.c, fxs, fys);
      const float iy = sample(s_gy, w1, 0, 0, w.r, w.c, fxs, fys);
      s_T[i] = sample(s_src, S, iys, ixs, w.r, w.c, fxs, fys);
      s_Ix[i] = ix;
      s_Iy[i] = iy;
      gxx += ix * ix;
      gxy += ix * iy;
      gyy += iy * iy;
    }
  }
  gxx = warp_sum(gxx);
  gxy = warp_sum(gxy);
  gyy = warp_sum(gyy);
  const float det = __fsub_rn(__fmul_rn(gxx, gyy), __fmul_rn(gxy, gxy));
  const float tr = __fadd_rn(gxx, gyy);
  const float disc = fmaxf(__fsub_rn(__fmul_rn(tr, tr), __fmul_rn(4.0f, det)), 0.0f);
  const float min_ev = __fmul_rn(__fsub_rn(tr, __fsqrt_rn(disc)), 0.5f);
  const bool ok = __fdiv_rn(min_ev, (float)n) > min_eig;
  const float inv_det = fabsf(det) > 1e-12f ? __fdiv_rn(1.0f, det) : 0.0f;

  // 4. LK chunks in the target window.
  cp_async_wait<0>();
  __syncwarp();
  float qx = corner(gx, otx, h, hi), qy = corner(gy, oty, h, hi);
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch > 0) {  // re-centre on the chunk's result and reload
      gx = __fadd_rn(__fadd_rn(qx, (float)otx), h);
      gy = __fadd_rn(__fadd_rn(qy, (float)oty), h);
      otx = origin(gx, S, W);
      oty = origin(gy, S, H);
      __syncwarp();  // every lane is done with the old window
      load_window(s_tgt, im_t, W, S, oty, otx, lane);
      cp_async_wait<0>();
      __syncwarp();
      qx = corner(gx, otx, h, hi);
      qy = corner(gy, oty, h, hi);
    }
    for (int it = 0; it < chunk_iters; ++it) {
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
        break;  // frozen: q no longer changes in this chunk
    }
  }

  // 5. Residual at the final corner, and the level's outputs.
  const float flx = floorf(qx), fly = floorf(qy);
  const int ix0 = (int)flx, iy0 = (int)fly;
  const float fx = __fsub_rn(qx, flx), fy = __fsub_rn(qy, fly);
  float e = 0.f;
  {
    Walk w(lane, win);
    for (int i = lane; i < n; i += 32, w.next())
      e += fabsf(__fsub_rn(sample(s_tgt, S, iy0, ix0, w.r, w.c, fx, fy), s_T[i]));
  }
  e = warp_sum(e);
  if (lane == 0) {
    gx = __fadd_rn(__fadd_rn(qx, (float)otx), h);
    gy = __fadd_rn(__fadd_rn(qy, (float)oty), h);
    new_guess[2 * kk] = __fadd_rn(px, __fsub_rn(gx, cx));
    new_guess[2 * kk + 1] = __fadd_rn(py, __fsub_rn(gy, cy));
    ok_out[kk] = ok;
    err_out[kk] = __fdiv_rn(e, (float)n);
  }
}

}  // namespace

// Dynamic shared memory of one block, in bytes.
extern "C" int epivo_track_level_smem(int S, int win) {
  return (int)(sizeof(float) * kWarps * floats_per_warp(S, win));
}

extern "C" int epivo_track_level(const float* src, const float* tgt,
                                 const float* pt_src, const float* guess,
                                 float* new_guess, unsigned char* ok,
                                 float* err, int B, int H, int W, int K, int S,
                                 int win, int chunk_iters, int n_chunks,
                                 float eps, float min_eig, float hi,
                                 cudaStream_t stream) {
  const int smem = epivo_track_level_smem(S, win);
  const cudaError_t e = cudaFuncSetAttribute(
      track_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((K + kWarps - 1) / kWarps, B);
  track_level_kernel<<<grid, kThreads, smem, stream>>>(
      src, tgt, pt_src, guess, new_guess, ok, err, H, W, K, S, win,
      chunk_iters, n_chunks, eps, min_eig, hi);
  return (int)cudaGetLastError();
}
