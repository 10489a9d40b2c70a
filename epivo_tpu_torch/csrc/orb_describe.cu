// Oriented BRIEF descriptors in one launch: the 37x37 window around each
// keypoint, its intensity-centroid angle, the 256 rotated bilinear tests
// and their bit packing.
//
// Replaces, on the ORB path, the TPU kernel
// epivo_tpu/frontend/pallas_klt.py::_extract_kernel (entries
// _extract_windows_batched / extract_windows_pallas, which the reference's
// describe calls for its windows) together with the torch chain of
// frontend/orb.py::describe around it. Plain version and oracle:
// epivo_tpu_torch/frontend/orb.py::describe_plain.
//
// Per keypoint (b, k) at (x, y), with S = 37 and r = 18:
//   1. origin ox = clamp(rint(x) - r, 0, W - S), oy alike, where rint
//      rounds half to even as torch.round does; ctr = (x - ox, y - oy);
//   2. m10 = sum v dx, m01 = sum v dy over the window pixels whose integer
//      offsets (dx, dy) from the centre lie in the circle dx^2 + dy^2 <=
//      15.5^2, in float64; angle = (float) atan2(m01, m10);
//   3. ca = cosf(angle), sa = sinf(angle); for test j with pattern
//      (ax, ay, bx, by): each end at ctr + (ca px - sa py, sa px + ca py),
//      clamped to [0, hi] (hi = S - 1.001 in float32) and sampled
//      bilinearly, rows first, then columns; bit j = va > vb;
//   4. signs [B, K, 256] = +-1, packed [B, K, 8] (bit i of word w is test
//      32 w + i), angle [B, K].
// Nothing of size [B, K, S, S] reaches device memory: the plain route
// writes those windows (5.6 MB at B = 2, K = 512) and reads them back in
// some thirty torch kernels.
//
// What bounds it on the H100: bytes. The function's inputs are the images
// (3.7 MB for two 376x1241 frames) and the keypoints; its outputs are 1 KB
// of signs per keypoint. Its operations (749 float64 multiply-adds per
// keypoint for the moments and ~55 float32 operations per test) take
// under a fifth of the bytes' time.
//
// Design: one warp per keypoint, kKeys keypoints per block, and no block
// barrier; the batch in gridDim.y. Each warp stages its 37x37 window
// (5.5 KB) into its own slice of shared memory with 4-byte cp.async:
// origins are arbitrary, so rows of an odd-width image are not 16-byte
// aligned, and TMA or wider copies do not apply (as in fast.cu and
// klt_level.cu). Lane l reads the pattern rows of tests l, l + 32, ...
// while the copy lands. The float64 moments are summed with xor shuffles,
// so every lane holds the same sums and computes the angle, its cosine
// and sine itself: once per keypoint in the warp's instruction stream,
// not once per test. Lane l then runs tests 32 j + l for j = 0..7 from
// shared memory; the warp's __ballot_sync of test j's bits is packed
// word j, written by lane 0, and the signs go out 128 bytes at a time.
// A first design, one block of 256 threads per keypoint with thread j
// owning test j, issued the window copy, the moments' loop and the whole
// scalar angle computation in 8 warps per keypoint, and one barrier per
// keypoint; it took 1.3-2.0x this design's device time at B = 2-64
// (PERF.md §6).
//
// Exactness: bit-equal to the plain version on the card in signs, packed
// and angle. Every product of a float32 sample and an integer offset is
// exact in float64, and so is their sum while its terms span fewer than
// 53 bits, so the moments do not depend on the order of the reduction.
// atan2 runs in double and cosf / sinf in float, as torch's CUDA kernels
// run them (no --use_fast_math); the angle reaches sinf through an opaque
// move, so nvcc cannot merge the two calls into one sincosf. The rotated
// positions and the blend use round-to-nearest intrinsics in the plain
// version's order of terms, where torch rounds between operations, so
// nvcc contracts nothing into an FMA.

#include <cuda_runtime.h>

namespace {

constexpr int kS = 37;             // window size: PATCH + margin
constexpr int kR = kS / 2;         // integer offsets -kR..kR
constexpr int kCircle = 240;       // dx^2 + dy^2 <= (31 / 2)^2 = 240.25
constexpr int kTests = 256;        // BRIEF tests
constexpr int kWords = kTests / 32;  // packed words; tests per lane
constexpr int kKeys = 4;           // keypoints per block, one warp each
constexpr int kThreads = 32 * kKeys;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

// Row-major walk of lane, lane + 32, ... over the S x S window, keeping
// the (row, column) pair without a division per step.
struct Walk {
  int r, c;
  __device__ explicit Walk(int lane) : r(lane / kS), c(lane % kS) {}
  __device__ void next() {
    c += 32;
    if (c >= kS) {
      c -= kS;
      ++r;
    }
  }
};

// Window origin along one axis: clamp(rint(x) - kR, 0, n - kS). The clamp
// to +-1e8 keeps the integer conversion defined for wild coordinates.
__device__ __forceinline__ int origin(float x, int n) {
  const int c = __float2int_rn(fminf(fmaxf(x, -1e8f), 1e8f));
  return min(max(c - kR, 0), n - kS);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// One end of a test: ctr + (ca px - sa py, sa px + ca py), clamped to
// [0, hi], sampled bilinearly from the shared window as _sample_points
// blends: col0 = (1-fy) a00 + fy a10, col1 = (1-fy) a01 + fy a11,
// v = (1-fx) col0 + fx col1.
__device__ __forceinline__ float tap(const float* win, float cx, float cy,
                                     float ca, float sa, float px, float py,
                                     float hi) {
  const float rx = __fsub_rn(__fmul_rn(ca, px), __fmul_rn(sa, py));
  const float ry = __fadd_rn(__fmul_rn(sa, px), __fmul_rn(ca, py));
  const float qx = fminf(fmaxf(__fadd_rn(cx, rx), 0.0f), hi);
  const float qy = fminf(fmaxf(__fadd_rn(cy, ry), 0.0f), hi);
  const float flx = floorf(qx), fly = floorf(qy);
  const float fx = __fsub_rn(qx, flx), fy = __fsub_rn(qy, fly);
  const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
  const float* a = win + (int)fly * kS + (int)flx;
  const float col0 = __fadd_rn(__fmul_rn(gy, a[0]), __fmul_rn(fy, a[kS]));
  const float col1 = __fadd_rn(__fmul_rn(gy, a[1]), __fmul_rn(fy, a[kS + 1]));
  return __fadd_rn(__fmul_rn(gx, col0), __fmul_rn(fx, col1));
}

__global__ void __launch_bounds__(kThreads)
orb_describe_kernel(const float* __restrict__ img, const float* __restrict__ xy,
                    const float4* __restrict__ pattern,
                    float* __restrict__ signs, unsigned* __restrict__ packed,
                    float* __restrict__ angle, int H, int W, int K, float hi) {
  __shared__ float s_win[kKeys][kS * kS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = blockIdx.x * kKeys + warp;
  if (k >= K) return;  // whole warps only; no block barrier follows
  const size_t kk = (size_t)blockIdx.y * K + k;
  float* win = s_win[warp];

  // 1. Origin, and the window's copy; the lane's pattern rows meanwhile.
  const float x = xy[2 * kk], y = xy[2 * kk + 1];
  const int ox = origin(x, W), oy = origin(y, H);
  const float* src = img + (size_t)blockIdx.y * H * W + (size_t)oy * W + ox;
  {
    Walk w(lane);
    for (int i = lane; i < kS * kS; i += 32, w.next())
      cp_async4(win + i, src + (size_t)w.r * W + w.c);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  float4 p[kWords];  // (ax, ay, bx, by) of tests lane, lane + 32, ...
#pragma unroll
  for (int j = 0; j < kWords; ++j) p[j] = pattern[32 * j + lane];
  const float cx = __fsub_rn(x, (float)ox), cy = __fsub_rn(y, (float)oy);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();

  // 2. Moments over the circle, float64; every lane holds the same sums.
  double m10 = 0.0, m01 = 0.0;
  {
    Walk w(lane);
    for (int i = lane; i < kS * kS; i += 32, w.next()) {
      const int dx = w.c - kR, dy = w.r - kR;
      if (dx * dx + dy * dy <= kCircle) {
        const double v = (double)win[i];
        m10 += v * (double)dx;
        m01 += v * (double)dy;
      }
    }
  }
  m10 = warp_sum(m10);
  m01 = warp_sum(m01);
  const float ang = (float)atan2(m01, m10);
  float ang_s;  // the same bits, opaque to nvcc: no merged sincosf
  asm volatile("mov.f32 %0, %1;" : "=f"(ang_s) : "f"(ang));
  const float ca = cosf(ang), sa = sinf(ang_s);

  // 3-4. Tests 32 j + lane; word j is the warp's ballot of its bits.
  float* out = signs + kk * kTests;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const float va = tap(win, cx, cy, ca, sa, p[j].x, p[j].y, hi);
    const float vb = tap(win, cx, cy, ca, sa, p[j].z, p[j].w, hi);
    const bool bit = va > vb;
    out[32 * j + lane] = bit ? 1.0f : -1.0f;
    const unsigned word = __ballot_sync(kFull, bit);
    if (lane == 0) packed[kk * kWords + j] = word;
  }
  if (lane == 0) angle[kk] = ang;
}

}  // namespace

extern "C" int epivo_orb_describe(const float* img, const float* xy,
                                  const float* pattern, float* signs,
                                  unsigned* packed, float* angle, int B, int H,
                                  int W, int K, float hi, cudaStream_t stream) {
  const dim3 grid((K + kKeys - 1) / kKeys, B);
  orb_describe_kernel<<<grid, kThreads, 0, stream>>>(
      img, xy, reinterpret_cast<const float4*>(pattern), signs, packed, angle,
      H, W, K, hi);
  return (int)cudaGetLastError();
}
