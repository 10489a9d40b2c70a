// Radial-tangential undistortion of raw frames: for each destination
// (pinhole) pixel, the bilinear sample of the raw frame at the pixel's
// distorted position, 0 where that position leaves the frame.
//
// No TPU kernel corresponds: the reference undistorts on the host in numpy
// (epivo_tpu/datasets/euroc.py::undistort_map + remap). Plain version and
// oracle: epivo_tpu_torch/frontend/undistort.py::undistort_plain, bit for
// bit, which is that numpy code's arithmetic written in torch.
//
// Bit for bit with numpy. The source position is undistort_map's float64
// arithmetic in its order, rounded to float32. The weights are float64
// (numpy promotes float32 minus int64 to float64) and so is the four-tap
// sum, in numpy's order, rounded to float32 at the end. Every float64 step
// is an _rn intrinsic, so nvcc contracts nothing into an FMA.
//
// What bounds it on the H100: bytes. Each frame is read once (the taps of
// a warp's 32 neighbouring pixels fall on two rows of ~33 neighbouring
// source pixels, served by L1/L2) and its undistorted copy written once: 8
// B a pixel, 185 MB for a batch-32 step's 64 frames at 752x480, 55 us at
// 3.35 TB/s. The map costs ~25 float64 operations and two divisions a
// pixel; it depends on the pixel alone, so a thread computes it once and
// applies it to FRAMES_PER_THREAD frames, which leaves ~15 float64
// operations a pixel and frame (~20 us at the card's float64 rate).
//
// One launch takes the frames of two inputs (a step's source and target
// frames), so a step undistorts both without copying them into one tensor:
// frame f < n0 comes from src0, the rest from src1, all into dst.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int FRAMES_PER_THREAD = 8;

__global__ void __launch_bounds__(THREADS)
undistort_remap_kernel(const float* __restrict__ src0, const float* __restrict__ src1,
                       float* __restrict__ dst, int n0, int n, int H, int W, double fx,
                       double fy, double cx, double cy, double k1, double k2, double p1,
                       double p2) {
  const long long HW = static_cast<long long>(H) * W;
  const long long p = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (p >= HW) return;
  const int row = static_cast<int>(p / W), col = static_cast<int>(p % W);

  // undistort_map: normalized pinhole coordinates, then the lens model.
  const double x = __ddiv_rn(__dsub_rn(static_cast<double>(col), cx), fx);
  const double y = __ddiv_rn(__dsub_rn(static_cast<double>(row), cy), fy);
  const double r2 = __dadd_rn(__dmul_rn(x, x), __dmul_rn(y, y));
  const double radial =
      __dadd_rn(__dadd_rn(1.0, __dmul_rn(k1, r2)), __dmul_rn(__dmul_rn(k2, r2), r2));
  const double xd = __dadd_rn(
      __dadd_rn(__dmul_rn(x, radial), __dmul_rn(__dmul_rn(__dmul_rn(2.0, p1), x), y)),
      __dmul_rn(p2, __dadd_rn(r2, __dmul_rn(__dmul_rn(2.0, x), x))));
  const double yd = __dadd_rn(
      __dadd_rn(__dmul_rn(y, radial),
                __dmul_rn(p1, __dadd_rn(r2, __dmul_rn(__dmul_rn(2.0, y), y)))),
      __dmul_rn(__dmul_rn(__dmul_rn(2.0, p2), x), y));
  const float mx = __double2float_rn(__dadd_rn(__dmul_rn(fx, xd), cx));
  const float my = __double2float_rn(__dadd_rn(__dmul_rn(fy, yd), cy));

  // remap: the clipped floor, the clipped float64 weights, out of range.
  const int x0 = min(max(static_cast<int>(floorf(mx)), 0), W - 2);
  const int y0 = min(max(static_cast<int>(floorf(my)), 0), H - 2);
  const double wx = fmin(fmax(__dsub_rn(static_cast<double>(mx), x0), 0.0), 1.0);
  const double wy = fmin(fmax(__dsub_rn(static_cast<double>(my), y0), 0.0), 1.0);
  const double gx = __dsub_rn(1.0, wx), gy = __dsub_rn(1.0, wy);
  const bool oob = mx < 0.0f || mx > static_cast<float>(W - 1) || my < 0.0f ||
                   my > static_cast<float>(H - 1);
  const long long tap = static_cast<long long>(y0) * W + x0;

  const int f_end = min(n, static_cast<int>(blockIdx.y + 1) * FRAMES_PER_THREAD);
  for (int f = blockIdx.y * FRAMES_PER_THREAD; f < f_end; ++f) {
    float out = 0.0f;
    if (!oob) {
      const float* a = f < n0 ? src0 + f * HW : src1 + (f - n0) * HW;
      a += tap;
      const double v00 = __ldg(a), v01 = __ldg(a + 1);
      const double v10 = __ldg(a + W), v11 = __ldg(a + W + 1);
      double t = __dmul_rn(__dmul_rn(v00, gx), gy);
      t = __dadd_rn(t, __dmul_rn(__dmul_rn(v01, wx), gy));
      t = __dadd_rn(t, __dmul_rn(__dmul_rn(v10, gx), wy));
      t = __dadd_rn(t, __dmul_rn(__dmul_rn(v11, wx), wy));
      out = __double2float_rn(t);
    }
    dst[f * HW + p] = out;
  }
}

}  // namespace

extern "C" {

int epivo_undistort(const float* src0, const float* src1, float* dst, int n0, int n1,
                    int H, int W, double fx, double fy, double cx, double cy, double k1,
                    double k2, double p1, double p2, void* stream) {
  const int n = n0 + n1;
  if (n <= 0 || H < 2 || W < 2) return static_cast<int>(cudaErrorInvalidValue);
  const long long HW = static_cast<long long>(H) * W;
  const dim3 grid(static_cast<unsigned>((HW + THREADS - 1) / THREADS),
                  static_cast<unsigned>((n + FRAMES_PER_THREAD - 1) / FRAMES_PER_THREAD));
  undistort_remap_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      src0, src1, dst, n0, n, H, W, fx, fy, cx, cy, k1, k2, p1, p2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
