// An empty kernel.  It replaces no TPU kernel and no path of the port
// launches it: chip_smoke.py times it at one warp and at the grids of the
// sparse FE (K2) and the fused matcher (K3), beside the kernels' bounds,
// as the practical floor of a launch's device time on this card.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int empty_launch(int blocks, int threads, cudaStream_t stream) {
  empty_kernel<<<blocks, threads, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
