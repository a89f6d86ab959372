// Single-pair Hamming matcher of the unfused Feature Matcher schedule:
// the masked Hamming argmin of every left feature of ONE stereo pair
// over its right features, in one launch.
//
// Replaces the TPU kernel repro/kernels/hamming_match.py::
// hamming_match_pallas (pl.pallas_call at line 95, body _kernel at :60
// over masked_hamming at :38): per left feature, the Hamming distance
// over 8 words inside the search region (0 <= xl - xr <= max_disp,
// |yl - yr| <= row_band, same level, both valid), a strict-< running
// minimum and the lowest right index that reaches it; (BIG, -1) where
// no candidate survives (ops.hamming_match strips the TPU's padded
// rows and maps BIG to -1; here no row is padded).
//
// Bound on an H100 SXM at one 720p pair (1000 x 1000 features): about
// 0.05 MB of descriptors and meta rows, well under 0.1 us at 3.35 TB/s;
// 1 M candidate pairs at ~10 operations for the search-region test
// (plus 26 for the few inside it), about 0.15 us at 67 TFLOP/s.  Both
// are far below a launch's latency: the kernel is bound by launch
// latency and by each warp's serial walk over the right features.
//
// Design: the match-only kernel's search (matcher_common.cuh) on one
// pair: one warp per left feature, eight per block.  The TPU's 128 x
// 128 tiles, its sequential M grid axis carrying the running argmin
// and its padding of K and M to tile multiples are not needed: a warp
// walks its own right features to M and the shuffle reduction keeps
// the lowest index among equal distances.
#include "matcher_common.cuh"

namespace {

constexpr int WARPS = 8;

__global__ void __launch_bounds__(WARPS * 32)
hamming_argmin_kernel(const int* __restrict__ dl,
                      const float* __restrict__ ml,
                      const int* __restrict__ dr,
                      const float* __restrict__ mr, int* __restrict__ dist,
                      int* __restrict__ idx, int K, int M, float row_band,
                      float max_disp) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * WARPS + warp;
  if (q >= K) return;                     // whole warp leaves

  int best = matcher::BIG, bidx = -1;
  if (ml[4 * q + 3] > 0.5f) {             // uniform over the warp
    unsigned d[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) d[k] = static_cast<unsigned>(dl[8 * q + k]);
    matcher::warp_hamming_argmin(d, ml[4 * q], ml[4 * q + 1], ml[4 * q + 2],
                                 dr, mr, M, row_band, max_disp, lane, best,
                                 bidx);
  }
  if (lane == 0) {
    dist[q] = best;
    idx[q] = bidx;
  }
}

}  // namespace

extern "C" int hamming_match(const int* dl, const float* ml, const int* dr,
                             const float* mr, int* dist, int* idx, int K,
                             int M, float row_band, float max_disp,
                             cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((K + WARPS - 1) / WARPS));
  hamming_argmin_kernel<<<grid, WARPS * 32, 0, stream>>>(
      dl, ml, dr, mr, dist, idx, K, M, row_band, max_disp);
  return static_cast<int>(cudaGetLastError());
}
