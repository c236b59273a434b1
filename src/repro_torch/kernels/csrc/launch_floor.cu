// An empty kernel, for measurement only: its device time at a kernel's grid
// is the floor under that kernel's time at shapes where the launch, not the
// work, dominates (chip_smoke.py times it beside the extraction and the
// fused tail at the serving shape). No path of the port launches it.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// Returns the launch's cudaError_t (0 on success).
extern "C" int repro_empty_kernel(int grid, int threads, void* stream) {
  empty_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
