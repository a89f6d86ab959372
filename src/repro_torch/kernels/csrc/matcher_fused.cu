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
// pixels, 0.1 us at 3.35 TB/s; the instructions of a banded search and of
// 2.7 M SAD terms at their pipes' rates (chip_smoke.py matcher_bound)
// are under 0.3 us.  Both are far below a launch's latency: the target
// is one short wave.
//
// Design: a block owns one pair and a tile of 16 left features, one warp
// each (63 tiles a pair, 126 blocks: one wave on the 132 SMs).  It stages
// the pair's meta rows in shared memory once (matcher_common.cuh
// block_argmin: coalesced 16 B loads, 16 KB for M = 1000), so each warp's
// walk over them reads shared memory, not the same 1000 meta rows from
// L2 as every other warp; the few candidates inside the search region
// read their descriptors from L2 (the 2-row band: staging the 32 KB of
// descriptors measured slower, PERF.md); lanes stride over
// the right features in index order, strict-< running minima merged on
// (distance, index), the reference's first-occurrence argmin.  The gate
// reads the merged result; an invalid left feature skips the search and
// still runs the SAD at the fallback center (right feature 0).  The SAD
// sweep gives lane r row r of the window and of the strip, read straight
// into registers (faster here on the card than reading them coalesced
// through shared memory, as K5 and K10 do; PERF.md), sums all 11 shifts
// at once and reduces them in one transposing pass
// (sweep_rows<11, 5>: the paper's sizes, unrolled; other sizes within
// MAXP / MAXR run sweep_rows<MAXP, MAXR>); the argmin over shifts is the
// lexicographic (SAD, shift) minimum, i.e. the first occurrence.
//
// Pixel types: one template, launched as match_kernel<float, ...>
// (match_rectify_fused) and match_kernel<unsigned char, ...>
// (match_rectify_fused_u8, on the uint8 datapath's level-0 images).  The
// SAD runs in int32 either way, so on an integer-valued frame the two
// give bit-equal outputs.
#include "matcher_common.cuh"

namespace {

using matcher::MAXP;
using matcher::MAXR;

constexpr int WARPS = 16;
constexpr int NT = WARPS * 32;

template <typename Pix, int PM, int RM>
__global__ void __launch_bounds__(NT)
match_kernel(const int* __restrict__ dl, const float* __restrict__ ml,
             const int* __restrict__ dr, const float* __restrict__ mr,
             const Pix* __restrict__ il, const Pix* __restrict__ ir,
             int* __restrict__ dist_out, int* __restrict__ idx_out,
             float* __restrict__ rxy_out, int* __restrict__ sad_out, int K,
             int M, int H, int W, float row_band, float max_disp,
             int max_hamming, int patch, int sad_range, int vec) {
  extern __shared__ uint4 smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.y;
  const int k = blockIdx.x * WARPS + warp;
  const bool has = k < K;                 // uniform over the warp
  const long long q = static_cast<long long>(p) * K + k;

  float lx = 0.f, ly = 0.f, llv = 0.f;
  bool lvalid = false;
  unsigned d[8] = {};
  if (has) {
    lx = ml[4 * q];
    ly = ml[4 * q + 1];
    llv = ml[4 * q + 2];
    lvalid = ml[4 * q + 3] > 0.5f;
#pragma unroll
    for (int w = 0; w < 8; ++w) d[w] = static_cast<unsigned>(dl[8 * q + w]);
  }
  const float* mrp = mr + static_cast<long long>(p) * M * 4;
  int best, bidx;
  matcher::block_argmin<NT, false>(has && lvalid, d, lx, ly, llv, mrp,
                            dr + static_cast<long long>(p) * M * 8, M,
                            vec != 0, row_band, max_disp, smem, lane, best,
                            bidx);
  if (!has) return;                       // after the block's barriers

  const bool ok = bidx >= 0 && best <= max_hamming && lvalid;
  const int eff = ok ? bidx : 0;
  const float rx = mrp[4 * eff], ry = mrp[4 * eff + 1];

  // SAD rectification, every shift at once.  The paper's <11, 5> sizes
  // are constants (its guards fold away); the generic <MAXP, MAXR>
  // instantiation takes them from the arguments.
  constexpr bool kGeneric = PM == MAXP && RM == MAXR;
  const int pw = kGeneric ? patch : PM, pr = kGeneric ? sad_range : RM;
  const long long img = static_cast<long long>(p) * H * W;
  const matcher::ImageRows<Pix> left(il + img, H, W, lx, ly, pw / 2, pw / 2);
  const matcher::ImageRows<Pix> right(ir + img, H, W, rx, ry, pw / 2,
                                      (pw + 2 * pr) / 2);
  int sads[matcher::Shifts<RM>::GROUPS];
  matcher::sweep_rows<PM, RM, false>(left, right, pw, pr, lane, nullptr,
                                     sads);
  const int shift = matcher::sweep_argmin<RM>(sads, pr, lane);

  if (lane == 0) {
    dist_out[q] = best;
    idx_out[q] = bidx;
    rxy_out[2 * q] = rx;
    rxy_out[2 * q + 1] = ry;
    sad_out[q] = shift;
  }
}

template <typename Pix, int PM, int RM>
int launch_sizes(const int* dl, const float* ml, const int* dr,
                 const float* mr, const Pix* il, const Pix* ir, int* dist,
                 int* idx, float* rxy, int* sad, int P, int K, int M, int H,
                 int W, float row_band, float max_disp, int max_hamming,
                 int patch, int sad_range, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((K + WARPS - 1) / WARPS),
                  static_cast<unsigned>(P));
  match_kernel<Pix, PM, RM><<<grid, NT, matcher::search_smem_bytes<false>(M),
                              stream>>>(
      dl, ml, dr, mr, il, ir, dist, idx, rxy, sad, K, M, H, W, row_band,
      max_disp, max_hamming, patch, sad_range, matcher::rows_aligned(mr, dr));
  return static_cast<int>(cudaGetLastError());
}

template <typename Pix>
int launch(const int* dl, const float* ml, const int* dr, const float* mr,
           const Pix* il, const Pix* ir, int* dist, int* idx, float* rxy,
           int* sad, int P, int K, int M, int H, int W, float row_band,
           float max_disp, int max_hamming, int patch, int sad_range,
           cudaStream_t stream) {
  // The gate's fallback reads right feature 0: M >= 1.
  if (patch < 1 || patch > MAXP || sad_range < 0 || sad_range > MAXR ||
      M < 1 || P > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (patch == 11 && sad_range == 5)
    return launch_sizes<Pix, 11, 5>(dl, ml, dr, mr, il, ir, dist, idx, rxy,
                                    sad, P, K, M, H, W, row_band, max_disp,
                                    max_hamming, patch, sad_range, stream);
  return launch_sizes<Pix, MAXP, MAXR>(dl, ml, dr, mr, il, ir, dist, idx,
                                       rxy, sad, P, K, M, H, W, row_band,
                                       max_disp, max_hamming, patch,
                                       sad_range, stream);
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
