// SAD sweep of the unfused Feature Matcher schedule: the int32 SAD
// table of caller-gathered windows, in one launch.
//
// Replaces the TPU kernel repro/kernels/sad_rectify.py::
// sad_search_pallas (pl.pallas_call at line 44, body _kernel at :27):
// per keypoint, the (P, P) left patch against the (P, P + 2R) right
// strip at each of the 2R + 1 shifts, both truncated to int32 (the
// reference's astype, toward zero) before the differences.  The caller
// (core.matching.sad_rectify_unfused) gathers the windows with
// ref.gather_patches and takes the first-occurrence argmin.
//
// Bound on an H100 SXM at one 720p pair (1000 keypoints, 11 x 11
// windows, +-5 shifts): 1000 x (121 + 231) float32 pixels in and the
// 44 KB table out, about 0.4 us at 3.35 TB/s; 1.3 M SAD terms at 3
// operations, about 0.06 us at 67 TFLOP/s.  Both are far below a
// launch's latency: the kernel is bound by launch latency.
//
// Design: one warp per keypoint row, eight per block.  The warp reads
// its patch and strip once, coalesced, into shared memory as int32
// (the truncation happens there), then reduces each shift's SAD over
// the warp (matcher::warp_sad, the sweep of the fused and SAD-only
// kernels) and lanes 0..2R write the table row.  The TPU's 128-row
// blocks and the padding of K to them are not needed: K is any size.
// Windows up to MAXP px and sweeps up to +-MAXR px fit the warp's
// shared buffers; the wrapper refuses larger ones.
#include "matcher_common.cuh"

namespace {

using matcher::MAXP;
using matcher::MAXR;

constexpr int WARPS = 8;

__global__ void __launch_bounds__(WARPS * 32)
sad_search_kernel(const float* __restrict__ lp, const float* __restrict__ rs,
                  int* __restrict__ table, int K, int patch, int sad_range) {
  __shared__ int s_l[WARPS][MAXP * MAXP];
  __shared__ int s_r[WARPS][MAXP * (MAXP + 2 * MAXR)];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * WARPS + warp;
  if (q >= K) return;                     // whole warp leaves
  const int sw = patch + 2 * sad_range;   // strip width
  const float* l = lp + static_cast<long long>(q) * patch * patch;
  const float* r = rs + static_cast<long long>(q) * patch * sw;
  for (int i = lane; i < patch * patch; i += 32)
    s_l[warp][i] = static_cast<int>(l[i]);
  for (int i = lane; i < patch * sw; i += 32)
    s_r[warp][i] = static_cast<int>(r[i]);
  __syncwarp();
  const int sweep = 2 * sad_range + 1;
  int mine = 0;
  for (int s = 0; s < sweep; ++s) {
    const int acc = matcher::warp_sad(s_l[warp], s_r[warp], patch,
                                      sad_range, s, lane);
    if (lane == s) mine = acc;
  }
  if (lane < sweep) table[static_cast<long long>(q) * sweep + lane] = mine;
}

}  // namespace

extern "C" int sad_search(const float* lp, const float* rs, int* table,
                          int K, int patch, int sad_range,
                          cudaStream_t stream) {
  if (patch < 1 || patch > MAXP || sad_range < 0 || sad_range > MAXR)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((K + WARPS - 1) / WARPS));
  sad_search_kernel<<<grid, WARPS * 32, 0, stream>>>(lp, rs, table, K,
                                                     patch, sad_range);
  return static_cast<int>(cudaGetLastError());
}
