// KLT window extraction: out[b, k] = img[b, oy:oy+S, ox:ox+S].
//
// Replaces the TPU kernel epivo_tpu/frontend/pallas_klt.py::_extract_kernel
// (entries _extract_windows_batched / extract_windows_pallas). Plain version
// and oracle: epivo_tpu_torch/frontend/klt.py::extract_windows_plain.
//
// What bounds it on the H100: bytes. It is a gather that moves K*S*S
// floats each way (512 windows of 46x46 are 4.3 MB) and computes nothing;
// at these sizes the launch, not HBM bandwidth, is most of its time.
//
// Design: one block per (k, b) window; the threads walk the window row by
// row, neighbouring threads on neighbouring columns, so each row is one
// coalesced read from the image and one coalesced write to the output.
// The TPU kernel's image-in-VMEM staging, rotate compaction, S <= 128 limit
// and VMEM-fit fallback exist only for the TPU and do not come across.
// Origins are clamped to [0, H - S] x [0, W - S] here, as the reference
// clips them and jax.lax.dynamic_slice clamps them, so the wrapper needs no
// host-side check. A copy: bit-exact.

#include <cuda_runtime.h>

namespace {

__global__ void extract_windows_kernel(const float* __restrict__ img,
                                       const int* __restrict__ oy,
                                       const int* __restrict__ ox,
                                       float* __restrict__ out, int H, int W,
                                       int K, int S) {
  const int k = blockIdx.x;
  const int b = blockIdx.y;
  const int y0 = min(max(oy[b * K + k], 0), H - S);
  const int x0 = min(max(ox[b * K + k], 0), W - S);
  const float* src = img + (size_t)b * H * W + (size_t)y0 * W + x0;
  float* dst = out + ((size_t)b * K + k) * S * S;
  for (int i = threadIdx.x; i < S * S; i += blockDim.x) {
    const int r = i / S, c = i - r * S;
    dst[i] = src[(size_t)r * W + c];
  }
}

}  // namespace

extern "C" int epivo_extract_windows(const float* img, const int* oy,
                                     const int* ox, float* out, int B, int H,
                                     int W, int K, int S,
                                     cudaStream_t stream) {
  dim3 grid(K, B);
  extract_windows_kernel<<<grid, 256, 0, stream>>>(img, oy, ox, out, H, W, K, S);
  return (int)cudaGetLastError();
}
