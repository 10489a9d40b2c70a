// Stage marks of the VO step: one kernel per stage boundary, each one
// thread doing nothing, named after its stage. Launched on the step's
// stream (``utils/profiling.py::mark``), a mark is captured into the
// step's CUDA graph like any kernel, so a device trace of a replay splits
// the step by stage from the kernel records alone: an activity belongs to
// the stage of the last mark that started before it.
//
// Stage numbers follow ``profiling.STAGES``: 0 undistort (raw frames
// undistorted, only where the step's configuration has a distortion), 1
// frontend (FAST, KLT or ORB, normalisation), 2 estimate (sampling, RANSAC /
// LMedS, refine-E, recoverPose), 3 refine (LM, revert, triangulation), 4 end.

#include <cuda_runtime.h>

extern "C" {

__global__ void stage_mark_undistort_kernel() {}
__global__ void stage_mark_frontend_kernel() {}
__global__ void stage_mark_estimate_kernel() {}
__global__ void stage_mark_refine_kernel() {}
__global__ void stage_mark_end_kernel() {}

int epivo_stage_mark(int stage, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case 0: stage_mark_undistort_kernel<<<1, 1, 0, s>>>(); break;
    case 1: stage_mark_frontend_kernel<<<1, 1, 0, s>>>(); break;
    case 2: stage_mark_estimate_kernel<<<1, 1, 0, s>>>(); break;
    case 3: stage_mark_refine_kernel<<<1, 1, 0, s>>>(); break;
    case 4: stage_mark_end_kernel<<<1, 1, 0, s>>>(); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
