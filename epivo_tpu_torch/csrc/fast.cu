// FAST-9/16 corner score with fused 3x3 non-maximum suppression.
//
// Replaces the TPU kernel epivo_tpu/frontend/pallas_fast.py::_fast_tile_kernel
// (entry fast_score_map_pallas). Plain version and oracle:
// epivo_tpu_torch/frontend/fast.py::fast_score_map + nms3.
//
// What bounds it on the H100: bytes. Per pixel it reads one float and
// writes one float, with ~300 min/max/sub operations in between; a
// 376x1241 frame is 1.9 MB each way, a few microseconds at HBM speed, so
// the kernel is bound by launch latency and by shared-memory traffic, not
// by arithmetic.
//
// Design: one block per 32x32 output tile, batch in gridDim.z. The block
// stages the tile plus a 4-pixel halo (3 for the FAST ring, 1 for the NMS
// apron) in shared memory, with coordinates clamped to the image so the
// halo reproduces mode="edge" padding. It scores the 34x34 tile-plus-apron
// into shared memory (pixels outside the image or in the 3-pixel border
// score 0, as in the reference), synchronises, and applies NMS from shared
// memory, so the un-suppressed map never goes to device memory.
//
// It only subtracts, takes min/max and compares, so it is bit-exact with
// the plain version. Do not build it with --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kHalo = 3;                       // FAST ring radius
constexpr int kApron = 1;                      // NMS neighbourhood
constexpr int kIn = kTile + 2 * (kHalo + kApron);  // 40: staged input edge
constexpr int kSc = kTile + 2 * kApron;           // 34: scored edge
constexpr int kArc = 9;

// Bresenham circle of radius 3, clockwise from the top (fast.CIRCLE).
__constant__ int kRingDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kRingDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

__global__ void fast_score_kernel(const float* __restrict__ img,
                                  float* __restrict__ out, int H, int W,
                                  float threshold, int nms) {
  __shared__ float s_in[kIn][kIn];
  __shared__ float s_sc[kSc][kSc];

  const int b = blockIdx.z;
  const float* im = img + (size_t)b * H * W;
  float* o = out + (size_t)b * H * W;
  const int y0 = blockIdx.y * kTile;  // image coords of the tile's origin
  const int x0 = blockIdx.x * kTile;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  // Stage input with an edge-clamped halo.
  for (int i = tid; i < kIn * kIn; i += nthreads) {
    int r = i / kIn, c = i % kIn;
    int gy = min(max(y0 - kHalo - kApron + r, 0), H - 1);
    int gx = min(max(x0 - kHalo - kApron + c, 0), W - 1);
    s_in[r][c] = im[(size_t)gy * W + gx];
  }
  __syncthreads();

  // Score the tile plus its apron.
  for (int i = tid; i < kSc * kSc; i += nthreads) {
    int r = i / kSc, c = i % kSc;
    int gy = y0 - kApron + r;
    int gx = x0 - kApron + c;
    float score = 0.0f;
    if (gy >= kHalo && gy < H - kHalo && gx >= kHalo && gx < W - kHalo) {
      const int cy = r + kHalo, cx = c + kHalo;  // centre in s_in
      const float ctr = s_in[cy][cx];
      float d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) d[k] = s_in[cy + kRingDy[k]][cx + kRingDx[k]] - ctr;
      float bright = -3.4e38f, dark = -3.4e38f;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        float bmin = d[k], dmax = d[k];
#pragma unroll
        for (int a = 1; a < kArc; ++a) {
          float v = d[(k + a) & 15];
          bmin = fminf(bmin, v);
          dmax = fmaxf(dmax, v);
        }
        bright = fmaxf(bright, bmin);
        dark = fmaxf(dark, -dmax);
      }
      float s = fmaxf(bright, dark);
      score = s > threshold ? s : 0.0f;
    }
    s_sc[r][c] = score;
  }
  __syncthreads();

  // Suppress against the 8 neighbours and write the tile.
  for (int i = tid; i < kTile * kTile; i += nthreads) {
    int r = i / kTile, c = i % kTile;
    int gy = y0 + r, gx = x0 + c;
    if (gy >= H || gx >= W) continue;
    float ctr = s_sc[r + 1][c + 1];
    float res = ctr;
    if (nms) {
      float neigh = -3.4e38f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          if (dy != 1 || dx != 1) neigh = fmaxf(neigh, s_sc[r + dy][c + dx]);
      res = ctr >= neigh ? ctr : 0.0f;
    }
    o[(size_t)gy * W + gx] = res;
  }
}

}  // namespace

extern "C" int epivo_fast_score(const float* img, float* out, int B, int H,
                                int W, float threshold, int nms,
                                cudaStream_t stream) {
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  dim3 block(32, 8);
  fast_score_kernel<<<grid, block, 0, stream>>>(img, out, H, W, threshold, nms);
  return (int)cudaGetLastError();
}

extern "C" const char* epivo_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
