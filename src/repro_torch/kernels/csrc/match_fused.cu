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
// Bound on an H100 SXM at a localized 720p frame's shapes (2 pairs x 1000 x
// 1000 features): about 0.2 MB of descriptors and meta rows, well under
// 0.1 us at 3.35 TB/s; a banded search's instructions at their pipes'
// rates (chip_smoke.py band_search_pipes) well under 0.1 us.  Both are
// far below a launch's latency.
//
// Design: K3's search without its SAD half (matcher_common.cuh
// block_argmin): a block owns one batch row and a tile of 16 left
// features, one warp each, and stages the row's right features (meta rows
// and descriptors: the temporal window's band, 48 rows each way, passes
// many candidates) in shared memory once, so each warp walks shared
// memory.  The TPU's 128-row K
// tiles and its padding of K and M to tile multiples are not needed: the
// last tile's spare warps only help stage, and the walk stops at M.
#include "matcher_common.cuh"

namespace {

constexpr int WARPS = 16;
constexpr int NT = WARPS * 32;

__global__ void __launch_bounds__(NT)
match_only_kernel(const int* __restrict__ dl, const float* __restrict__ ml,
                  const int* __restrict__ dr, const float* __restrict__ mr,
                  int* __restrict__ dist_out, int* __restrict__ idx_out,
                  int K, int M, float row_band, float max_disp, int vec) {
  extern __shared__ uint4 smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int k = blockIdx.x * WARPS + warp;
  const bool has = k < K;                 // uniform over the warp
  const long long q = static_cast<long long>(b) * K + k;

  const bool search = has && ml[4 * q + 3] > 0.5f;
  unsigned d[8] = {};
  float lx = 0.f, ly = 0.f, llv = 0.f;
  if (search) {
    lx = ml[4 * q];
    ly = ml[4 * q + 1];
    llv = ml[4 * q + 2];
#pragma unroll
    for (int w = 0; w < 8; ++w) d[w] = static_cast<unsigned>(dl[8 * q + w]);
  }
  int best, bidx;
  matcher::block_argmin<NT, true>(
      search, d, lx, ly, llv, mr + static_cast<long long>(b) * M * 4,
      dr + static_cast<long long>(b) * M * 8, M, vec != 0, row_band,
      max_disp, smem, lane, best, bidx);
  if (has && lane == 0) {
    dist_out[q] = best;
    idx_out[q] = bidx;
  }
}

}  // namespace

extern "C" int match_fused(const int* dl, const float* ml, const int* dr,
                           const float* mr, int* dist, int* idx, int B, int K,
                           int M, float row_band, float max_disp,
                           cudaStream_t stream) {
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((K + WARPS - 1) / WARPS),
                  static_cast<unsigned>(B));
  match_only_kernel<<<grid, NT, matcher::search_smem_bytes<true>(M), stream>>>(
      dl, ml, dr, mr, dist, idx, K, M, row_band, max_disp,
      matcher::rows_aligned(mr, dr));
  return static_cast<int>(cudaGetLastError());
}
