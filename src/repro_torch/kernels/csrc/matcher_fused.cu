// The whole Feature Matcher stage of a frame in one launch.
//
// Replaces the TPU kernel repro/kernels/matcher_fused.py::
// match_rectify_fused_pallas (pl.pallas_call at line 208): per left
// feature of every stereo pair, the masked Hamming argmin over the
// pair's right features (row band, disparity range, same level, both
// valid; ties to the lowest index), the max_hamming gate with the
// fallback to right feature 0, and the int32 SAD of an 11x11 window
// against an 11x21 strip over the +-5 shifts, first-occurrence argmin.
//
// Bound on an H100 SXM at the paper's configuration (2 pairs x 1000 x
// 1000 features): about 0.3 MB of descriptors, meta rows and window
// pixels, 0.1 us at 3.35 TB/s; 2 M candidate pairs at ~10 operations
// for the search-region test (plus 26 for the few inside it) and 2.7 M
// SAD terms at 3: about 28 M operations, 0.4 us at 67 TFLOP/s.  Either
// is far below a launch's latency: the kernel is bound by launch
// latency and by each warp's serial walk over the right features.
//
// Design: one warp per left feature, eight per block, one launch over
// all pairs.  Lanes stride over the right features in index order,
// each keeping a strict-< running minimum, and a shuffle reduction on
// (distance, index) keeps the lowest index among equal distances — the
// reference's first-occurrence argmin.  Centers round half to even
// (rintf, not roundf) and clamp into the image; the window and strip
// are read from the level-0 images in global memory with clamped reads
// (the TPU kept whole slabs resident in VMEM), truncated to int32 as
// the reference's astype, and the SAD is summed in int32, so any order
// is exact.  The warp's search, window reads and SAD sweep are the
// helpers of matcher_common.cuh, shared with the match-only and SAD-only
// kernels.
//
// Pixel types: one template, launched as match_kernel<float>
// (match_rectify_fused) and match_kernel<unsigned char>
// (match_rectify_fused_u8, on the uint8 datapath's level-0 images).  The
// SAD runs in int32 either way, so on an integer-valued frame the two
// give bit-equal outputs.
#include "matcher_common.cuh"

namespace {

using matcher::MAXP;
using matcher::MAXR;

constexpr int WARPS = 8;

template <typename Pix>
__global__ void __launch_bounds__(WARPS * 32)
match_kernel(const int* __restrict__ dl, const float* __restrict__ ml,
             const int* __restrict__ dr, const float* __restrict__ mr,
             const Pix* __restrict__ il, const Pix* __restrict__ ir,
             int* __restrict__ dist_out, int* __restrict__ idx_out,
             float* __restrict__ rxy_out, int* __restrict__ sad_out, int P,
             int K, int M, int H, int W, float row_band, float max_disp,
             int max_hamming, int patch, int sad_range) {
  __shared__ int s_l[WARPS][MAXP * MAXP];
  __shared__ int s_r[WARPS][MAXP * (MAXP + 2 * MAXR)];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long q = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (q >= static_cast<long long>(P) * K) return;    // whole warp leaves
  const int p = static_cast<int>(q / K);

  const float lx = ml[4 * q], ly = ml[4 * q + 1], llv = ml[4 * q + 2];
  const bool lvalid = ml[4 * q + 3] > 0.5f;
  unsigned d[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) d[k] = static_cast<unsigned>(dl[8 * q + k]);

  const int* drp = dr + static_cast<long long>(p) * M * 8;
  const float* mrp = mr + static_cast<long long>(p) * M * 4;
  int best = matcher::BIG, bidx = -1;
  if (lvalid)                             // uniform over the warp
    matcher::warp_hamming_argmin(d, lx, ly, llv, drp, mrp, M, row_band,
                                 max_disp, lane, best, bidx);

  const bool ok = bidx >= 0 && best <= max_hamming && lvalid;
  const int eff = ok ? bidx : 0;
  const float rx = mrp[4 * eff], ry = mrp[4 * eff + 1];

  // SAD rectification.
  const Pix* imgl = il + static_cast<long long>(p) * H * W;
  const Pix* imgr = ir + static_cast<long long>(p) * H * W;
  matcher::load_windows(imgl, imgr, H, W, lx, ly, rx, ry, patch, sad_range,
                        lane, s_l[warp], s_r[warp]);
  int best_sad = 0, best_s = 0;
  for (int s = 0; s <= 2 * sad_range; ++s) {
    const int acc = matcher::warp_sad(s_l[warp], s_r[warp], patch,
                                      sad_range, s, lane);
    if (s == 0 || acc < best_sad) {
      best_sad = acc;
      best_s = s;
    }
  }

  if (lane == 0) {
    dist_out[q] = best;
    idx_out[q] = bidx;
    rxy_out[2 * q] = rx;
    rxy_out[2 * q + 1] = ry;
    sad_out[q] = best_s;
  }
}

template <typename Pix>
int launch(const int* dl, const float* ml, const int* dr, const float* mr,
           const Pix* il, const Pix* ir, int* dist, int* idx, float* rxy,
           int* sad, int P, int K, int M, int H, int W, float row_band,
           float max_disp, int max_hamming, int patch, int sad_range,
           cudaStream_t stream) {
  if (patch > MAXP || sad_range > MAXR)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(P) * K;
  const dim3 grid(static_cast<unsigned>((n + WARPS - 1) / WARPS));
  match_kernel<Pix><<<grid, WARPS * 32, 0, stream>>>(
      dl, ml, dr, mr, il, ir, dist, idx, rxy, sad, P, K, M, H, W, row_band,
      max_disp, max_hamming, patch, sad_range);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int match_rectify_fused(const int* dl, const float* ml,
                                   const int* dr, const float* mr,
                                   const float* il, const float* ir,
                                   int* dist, int* idx, float* rxy, int* sad,
                                   int P, int K, int M, int H, int W,
                                   float row_band, float max_disp,
                                   int max_hamming, int patch, int sad_range,
                                   cudaStream_t stream) {
  return launch(dl, ml, dr, mr, il, ir, dist, idx, rxy, sad, P, K, M, H, W,
                row_band, max_disp, max_hamming, patch, sad_range, stream);
}

extern "C" int match_rectify_fused_u8(const int* dl, const float* ml,
                                      const int* dr, const float* mr,
                                      const uint8_t* il, const uint8_t* ir,
                                      int* dist, int* idx, float* rxy,
                                      int* sad, int P, int K, int M, int H,
                                      int W, float row_band, float max_disp,
                                      int max_hamming, int patch,
                                      int sad_range, cudaStream_t stream) {
  return launch(dl, ml, dr, mr, il, ir, dist, idx, rxy, sad, P, K, M, H, W,
                row_band, max_disp, max_hamming, patch, sad_range, stream);
}
