// An empty kernel: the yardstick for kernels that one launch bounds.
//
// K5a / K5b (traj.cu) move a few KB, so the bytes over the memory rate say
// nothing about them; what they cannot beat is the device time of a launch
// of the same grid, block and shared memory that does no work. This file is
// not part of the library the package loads: chip_smoke.py and
// tools/kernel_ab.py build it on its own and time it with the same
// profiler reading as the kernels.

#include <cuda_runtime.h>

namespace {

__global__ void launch_floor_kernel() {}

}  // namespace

// Launch the empty kernel with the given configuration on ``stream``.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int vs_launch_floor(int blocks, int threads, int smem_bytes,
                               void* stream) {
  if (blocks <= 0 || threads <= 0 || threads > 1024 || smem_bytes < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem_bytes > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        launch_floor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  launch_floor_kernel<<<blocks, threads, smem_bytes,
                        static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
