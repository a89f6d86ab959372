// Match-only Feature Matcher: the masked Hamming argmin of every left
// feature over the right features of its batch row, in one launch.
//
// Replaces the TPU kernel repro/kernels/matcher_fused.py::
// match_fused_pallas (pl.pallas_call at line 252, body
// _match_only_kernel): per left feature of every batch row (a stereo
// pair for stereo_match, a pair of a frame transition for
// temporal_match and the localization backend), the Hamming distance
// over 8 words inside the search region (0 <= xl - xr <= max_disp,
// |yl - yr| <= row_band, same level, both valid), the minimum, and the
// lowest right index that reaches it; (BIG, -1) where no candidate
// survives.  The temporal window [-r, r] arrives as the caller's shift
// of the left x by +r with max_disp = 2r.
//
// Bound on an H100 SXM at a localized 720p frame's shapes (2 pairs x
// 1000 x 1000 features): about 0.2 MB of descriptors and meta rows, well
// under 0.1 us at 3.35 TB/s; 2 M candidate pairs at ~10 operations for
// the search-region test (plus 26 for the few inside it), about 0.3 us
// at 67 TFLOP/s.  Both are far below a launch's latency: the kernel is
// bound by launch latency and by each warp's serial walk over the right
// features.
//
// Design: K3's search without its SAD half (matcher_common.cuh): one
// warp per left feature, eight per block, one launch over every batch
// row.  The TPU's 128-row K tiles and its padding of K and M to tile
// multiples are not needed: a warp reads its own rows and stops at M.
#include "matcher_common.cuh"

namespace {

constexpr int WARPS = 8;

__global__ void __launch_bounds__(WARPS * 32)
match_only_kernel(const int* __restrict__ dl, const float* __restrict__ ml,
                  const int* __restrict__ dr, const float* __restrict__ mr,
                  int* __restrict__ dist_out, int* __restrict__ idx_out,
                  int B, int K, int M, float row_band, float max_disp) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long q = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (q >= static_cast<long long>(B) * K) return;    // whole warp leaves
  const int b = static_cast<int>(q / K);

  int best = matcher::BIG, bidx = -1;
  if (ml[4 * q + 3] > 0.5f) {             // uniform over the warp
    unsigned d[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) d[k] = static_cast<unsigned>(dl[8 * q + k]);
    matcher::warp_hamming_argmin(
        d, ml[4 * q], ml[4 * q + 1], ml[4 * q + 2],
        dr + static_cast<long long>(b) * M * 8,
        mr + static_cast<long long>(b) * M * 4, M, row_band, max_disp, lane,
        best, bidx);
  }
  if (lane == 0) {
    dist_out[q] = best;
    idx_out[q] = bidx;
  }
}

}  // namespace

extern "C" int match_fused(const int* dl, const float* ml, const int* dr,
                           const float* mr, int* dist, int* idx, int B, int K,
                           int M, float row_band, float max_disp,
                           cudaStream_t stream) {
  const long long n = static_cast<long long>(B) * K;
  const dim3 grid(static_cast<unsigned>((n + WARPS - 1) / WARPS));
  match_only_kernel<<<grid, WARPS * 32, 0, stream>>>(
      dl, ml, dr, mr, dist, idx, B, K, M, row_band, max_disp);
  return static_cast<int>(cudaGetLastError());
}
