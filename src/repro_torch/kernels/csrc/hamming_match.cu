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
// 0.05 MB of descriptors and meta rows, well under 0.1 us at 3.35 TB/s; a
// banded search's instructions at their pipes' rates (chip_smoke.py
// band_search_pipes) well under 0.1 us.  Both are far below a launch's
// latency.
//
// Design: the fused matcher's search (matcher_common.cuh block_argmin) on one
// pair: a block owns a tile of 16 left features, one warp each, and stages
// the pair's meta rows in shared memory once; the few candidates in the
// stereo search region read their descriptors from L2.  The TPU's 128 x 128
// tiles, its sequential M grid axis carrying the running argmin and its
// padding of K and M to tile multiples are not needed: lanes walk the staged
// right features in index order and the shuffle reduction keeps the lowest
// index among equal distances.
#include "matcher_common.cuh"

namespace {

constexpr int WARPS = 16;
constexpr int NT = WARPS * 32;

__global__ void __launch_bounds__(NT)
hamming_argmin_kernel(const int* __restrict__ dl,
                      const float* __restrict__ ml,
                      const int* __restrict__ dr,
                      const float* __restrict__ mr, int* __restrict__ dist,
                      int* __restrict__ idx, int K, int M, float row_band,
                      float max_disp, int vec) {
  extern __shared__ uint4 smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * WARPS + warp;
  const bool has = q < K;                 // uniform over the warp

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
  matcher::block_argmin<NT, false>(search, d, lx, ly, llv, mr, dr, M, vec != 0,
                            row_band, max_disp, smem, lane, best, bidx);
  if (has && lane == 0) {
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
  hamming_argmin_kernel<<<grid, NT, matcher::search_smem_bytes<false>(M),
                          stream>>>(dl, ml, dr, mr, dist, idx, K, M, row_band,
                                    max_disp, matcher::rows_aligned(mr, dr));
  return static_cast<int>(cudaGetLastError());
}
